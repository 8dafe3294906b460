"""DDPM / DDIM schedule helpers (port of covomix_tpu/util/ddpm_schedules.py).

  make_beta_schedule            linear / cosine / sqrt_linear / sqrt betas
  make_ddim_timesteps           uniform / quad DDIM subset, +1 offset
  make_ddim_sampling_parameters sigma_t per arXiv:2010.02502 eq. 16
  betas_for_alpha_bar           a continuous alpha-bar function, discretized
  extract_into_tensor           a[t] per batch element, reshaped to
                                broadcast against x_shape (a torch gather on
                                a's device)

The schedule builders are host-side float64 numpy (they run once at set-up);
only extract_into_tensor is torch, as it sits inside a step. Nothing on the
CoVoMix paths uses them (flow matching replaced score diffusion)."""

from __future__ import annotations

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule, float64 numpy [n_timestep]. DDPM_utils.py:226-248."""
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int, verbose: bool = True) -> np.ndarray:
    """DDIM timestep subset (+1 offset), int numpy. DDPM_utils.py:251-266."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                      num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{ddim_discr_method}"')
    steps_out = ddim_timesteps + 1
    if verbose:
        print(f"Selected timesteps for ddim sampler: {steps_out}")
    return steps_out


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                  eta: float, verbose: bool = True):
    """(sigmas, alphas, alphas_prev) per arXiv:2010.02502. DDPM_utils.py:269-280."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    if verbose:
        print(f"Selected alphas for ddim sampler: a_t: {alphas}; a_(t-1): {alphas_prev}")
        print(f"For the chosen value of eta, which is {eta}, "
              f"this results in the following sigma_t schedule for ddim sampler {sigmas}")
    return sigmas, alphas, alphas_prev


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999
                        ) -> np.ndarray:
    """Discretize a continuous alpha-bar function. DDPM_utils.py:283-298."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def extract_into_tensor(a: torch.Tensor, t: torch.Tensor, x_shape) -> torch.Tensor:
    """a[..., t] for each batch element (t [B] indices), reshaped to
    [B, 1, ..., 1] with len(x_shape) dims, on a's device."""
    b = t.shape[0]
    out = torch.gather(a, -1, t.to(device=a.device, dtype=torch.int64))
    return out.reshape(b, *((1,) * (len(x_shape) - 1)))
