"""The port's adaptive Tsit5 sampler and one-shot regression sample
(models/acoustic.py `sample_adaptive`, `sample_regression`) against the JAX
package on the same weights, with JAX's draws handed over: the same number
of attempted steps and y within 1e-4 of max |y| (f32), CFG on and off."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA
from covomix_tpu_torch.models import acoustic as PA

from _torch_port import port_cfg, to_port

J_TINY = JA.AcousticConfig(dim_in=80, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                           num_phoneme_tokens=502)
P_TINY = port_cfg(PA.AcousticConfig, J_TINY)


@pytest.fixture(scope="module")
def model():
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(0), J_TINY)
    return jp, to_port(jp)


def _inputs(seed, b, t):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 502, (b, t)).astype(np.int32), (rs.randn(b, t, 80) * 0.1).astype(np.float32)


def test_tsit5_tables_are_jax_tables():
    for name in ("_TSIT5_C", "_TSIT5_A", "_TSIT5_B", "_TSIT5_E"):
        assert getattr(PA, name) == getattr(JA, name), name


@pytest.mark.parametrize("cond_scale,b,t,tol", [(1.0, 1, 12, 1e-5), (0.7, 2, 16, 1e-5), (0.7, 1, 10, 1e-3)])
def test_sample_adaptive_matches_jax(model, cond_scale, b, t, tol):
    jp, pp = model
    ph, cond = _inputs(int(cond_scale * 10) + t, b, t)
    key = jax.random.PRNGKey(t)
    fn = functools.partial(JA.sample_adaptive, cfg=J_TINY, cond_scale=cond_scale, atol=tol, rtol=tol)
    with jax.default_matmul_precision("highest"):
        ref, ref_steps = jax.jit(fn)(jp, key=key, phoneme_ids=jnp.asarray(ph), cond=jnp.asarray(cond))
    y0 = np.array(jax.random.normal(key, (b, t, 80), jnp.float32))   # the draw sample_adaptive makes
    norms = []
    got, steps = PA.sample_adaptive(pp, P_TINY, None, torch.from_numpy(ph), torch.from_numpy(cond),
                                    cond_scale=cond_scale, atol=tol, rtol=tol, noise=torch.from_numpy(y0), norms=norms)
    ref = np.asarray(ref)
    assert isinstance(steps, int) and steps == int(ref_steps) and 1 < steps < 64
    assert len(norms) == steps and norms[-1] <= 1.0       # the last attempt reached t = 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sample_adaptive_bf16_runs_and_stops(model):
    """bf16 field: the noise floor keeps the controller from rejecting down
    to h ~ 0; the result is finite and ends within max_steps, near the f32
    trajectory (the bf16 noise floor's accuracy)."""
    _, pp = model
    ph, cond = _inputs(1, 1, 12)
    args = (pp, P_TINY, None, torch.from_numpy(ph), torch.from_numpy(cond))
    y0 = torch.randn((1, 12, 80), generator=torch.Generator().manual_seed(3))
    ref, steps32 = PA.sample_adaptive(*args, noise=y0)
    y16, steps16 = PA.sample_adaptive(*args, noise=y0, dtype=torch.bfloat16, max_steps=64)
    assert torch.isfinite(y16).all() and y16.dtype == torch.float32
    assert steps16 < 64 and steps16 <= steps32 + 16
    assert (y16 - ref).abs().max() / (ref.abs().mean() + 1e-6) < 0.15
    capped, n = PA.sample_adaptive(*args, noise=y0, dtype=torch.bfloat16, max_steps=3)
    assert n == 3 and torch.isfinite(capped).all()


@pytest.mark.parametrize("cond_scale", [1.0, 0.7])
def test_sample_regression_matches_jax(model, cond_scale):
    jp, pp = model
    ph, cond = _inputs(7, 2, 14)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(functools.partial(JA.sample_regression, cfg=J_TINY, cond_scale=cond_scale))(
            jp, key=key, phoneme_ids=jnp.asarray(ph), cond=jnp.asarray(cond)))
    kt, kn = jax.random.split(key)       # sample_regression's draws
    times = np.array(jax.random.uniform(kt, (2,)))
    y0 = np.array(jax.random.normal(kn, (2, 14, 80), jnp.float32))
    got = PA.sample_regression(pp, P_TINY, None, torch.from_numpy(ph), torch.from_numpy(cond),
                               cond_scale=cond_scale, noise=torch.from_numpy(y0), times=torch.from_numpy(times))
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    drawn = PA.sample_regression(pp, P_TINY, torch.Generator().manual_seed(0), torch.from_numpy(ph),
                                 torch.from_numpy(cond), cond_scale=cond_scale)
    assert drawn.shape == ref.shape and torch.isfinite(drawn).all()
