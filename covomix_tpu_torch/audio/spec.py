"""Complex STFT / iSTFT and the compressed-spectrum transforms of the legacy
enhancement path (port of covomix_tpu/audio/spec.py). Nothing on the CoVoMix
synthesis path uses them; `data/specs_legacy.Specs` does.

Both directions run against a precomputed DFT basis: for the analysis one
matmul of the framed signal, for the synthesis two einsums to windowed time
frames and an overlap-add (`F.fold`, the identity placement of each frame's
samples at frame_start + i). Spectra are complex64 tensors on the input's
device. The matmuls run in full f32 whatever the global TF32 flags say (the
JAX package pins Precision.HIGHEST)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from covomix_tpu_torch.audio.mel import _no_tf32


def get_window(window_type: str, window_length: int) -> np.ndarray:
    """'hann' (periodic) or 'sqrthann', f32 numpy."""
    n = np.arange(window_length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)
    if window_type == "hann":
        return hann.astype(np.float32)
    if window_type == "sqrthann":
        return np.sqrt(hann).astype(np.float32)
    raise NotImplementedError(f"Window type {window_type} not implemented!")


@functools.lru_cache(maxsize=8)
def _analysis_basis(n_fft: int, window_type: str) -> np.ndarray:
    """Windowed DFT basis [n_fft, 2F]: the re (cos) columns, then the im
    (-sin) ones."""
    win = get_window(window_type, n_fft).astype(np.float64)
    k = np.arange(n_fft)[:, None]
    f = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    return np.concatenate([(np.cos(ang) * win[:, None]).astype(np.float32),
                           (-np.sin(ang) * win[:, None]).astype(np.float32)], axis=1)


@functools.lru_cache(maxsize=8)
def _synthesis_matrices(n_fft: int, window_type: str):
    """Inverse-rDFT bases [F, n_fft] mapping (re, im) to a windowed time
    frame: x[n] = (1/N) sum_f w_f (re_f cos(2 pi f n / N) - im_f sin(2 pi f n / N))
    win[n], with w_f = 1 at DC / Nyquist and 2 otherwise (the onesided fold)."""
    nf = 1 + n_fft // 2
    win = get_window(window_type, n_fft).astype(np.float64)
    f = np.arange(nf)[:, None]
    nn = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * f * nn / n_fft
    fold = np.full((nf, 1), 2.0)
    fold[0] = 1.0
    if n_fft % 2 == 0:
        fold[-1] = 1.0
    c = (fold * np.cos(ang) / n_fft) * win[None, :]
    s = (-fold * np.sin(ang) / n_fft) * win[None, :]
    return c.astype(np.float32), s.astype(np.float32)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[B, frames, n_fft] -> [B, (frames - 1) * hop + n_fft]: sample i of
    frame j summed into position j * hop + i."""
    b, n, n_fft = frames.shape
    out = F.fold(frames.transpose(1, 2), output_size=(1, (n - 1) * hop_length + n_fft),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(b, -1)


def stft_complex(y: torch.Tensor, n_fft: int, hop_length: int, window_type: str = "hann",
                 center: bool = True) -> torch.Tensor:
    """torch.stft-matching complex STFT: [B, T] (or [T]) -> [B, F, frames]
    complex64 (onesided, win_length == n_fft, not normalized). center=True
    reflect-pads n_fft // 2 on each side, so frames = 1 + T // hop."""
    squeeze = y.dim() == 1
    x = y.float().reshape(-1, 1, y.shape[-1])
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    basis = torch.from_numpy(_analysis_basis(n_fft, window_type)).to(x.device)
    with _no_tf32():
        z = x[:, 0].unfold(-1, n_fft, hop_length) @ basis            # [B, frames, 2F]
    re, im = torch.chunk(z, 2, dim=-1)
    spec = torch.complex(re, im).transpose(1, 2)                     # [B, F, frames]
    return spec[0] if squeeze else spec


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, window_type: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """torch.istft-matching inverse: [B, F, frames] (or [F, frames]) complex
    -> [B, T] f32. Per frame the inverse rDFT with the window, the
    overlap-add, then division by the overlapped squared window."""
    squeeze = spec.dim() == 2
    if squeeze:
        spec = spec[None]
    dev = spec.device
    frames = spec.shape[-1]
    c, s = (torch.from_numpy(m).to(dev) for m in _synthesis_matrices(n_fft, window_type))
    with _no_tf32():
        fr = torch.einsum("bft,fn->btn", spec.real.float(), c) + torch.einsum("bft,fn->btn", spec.imag.float(), s)
    ola = _overlap_add(fr, hop_length)
    win = torch.from_numpy(get_window(window_type, n_fft)).to(dev)
    env = _overlap_add((win * win).expand(1, frames, n_fft), hop_length)[0]
    out = ola / torch.clamp(env, min=1e-11)[None]
    if center:
        p = n_fft // 2
        out = out[:, p: out.shape[1] - p]
    if length is not None:
        t = out.shape[1]
        out = out[:, :length] if t >= length else F.pad(out, (0, length - t))
    return out[0] if squeeze else out


def spec_fwd(spec: torch.Tensor, transform_type: str = "exponent", spec_factor: float = 0.15,
             spec_abs_exponent: float = 0.5) -> torch.Tensor:
    """Forward magnitude compression: 'exponent' -> |S|^e exp(i angle) factor;
    'log' -> log1p(|S|) exp(i angle) factor; 'none' -> identity."""
    if transform_type == "exponent":
        if spec_abs_exponent != 1:
            mag = torch.abs(spec)
            spec = torch.where(mag > 0, spec * mag ** (spec_abs_exponent - 1), spec)
        return spec * spec_factor
    if transform_type == "log":
        mag = torch.abs(spec)
        scale = torch.where(mag > 0, torch.log1p(mag) / torch.clamp(mag, min=1e-30), torch.ones_like(mag))
        return spec * scale * spec_factor
    if transform_type == "none":
        return spec
    raise ValueError(f"unknown transform_type {transform_type!r}")


def spec_back(spec: torch.Tensor, transform_type: str = "exponent", spec_factor: float = 0.15,
              spec_abs_exponent: float = 0.5) -> torch.Tensor:
    """Inverse of spec_fwd."""
    if transform_type == "exponent":
        spec = spec / spec_factor
        if spec_abs_exponent != 1:
            mag = torch.abs(spec)
            spec = torch.where(mag > 0, spec * mag ** (1.0 / spec_abs_exponent - 1), spec)
        return spec
    if transform_type == "log":
        spec = spec / spec_factor
        mag = torch.abs(spec)
        scale = torch.where(mag > 0, torch.expm1(mag) / torch.clamp(mag, min=1e-30), torch.ones_like(mag))
        return spec * scale
    if transform_type == "none":
        return spec
    raise ValueError(f"unknown transform_type {transform_type!r}")
