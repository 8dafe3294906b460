"""The port's flow-matching acoustic model (VoMix, two_one) against the JAX
package on the same weights, inputs and noise. f32, 'highest' precision.
Tolerance 1e-4 on the sampled mel: 32 field evaluations of a 2-layer model
integrate summation-order differences of ~1e-6 per evaluation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA
from covomix_tpu_torch.models import acoustic as PA

from _torch_port import J_AC, P_AC, jax_params, to_port, tree_shapes

B, T = 3, 40


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    ph = rs.randint(0, 502, (B, T, 2)).astype(np.int32)
    cond = (rs.randn(B, T, 160) * 0.5).astype(np.float32)
    noise = rs.randn(B, T, 80).astype(np.float32)
    return ph, cond, noise


@pytest.fixture(scope="module")
def params():
    jp = jax_params(0)[1]
    return jp, to_port(jp)


def test_init_names_and_shapes_match():
    jp = jax_params(0)[1]
    pp = PA.init(torch.Generator().manual_seed(0), P_AC)
    assert tree_shapes(pp) == tree_shapes(jp)


@pytest.mark.parametrize("valid", [None, np.array([40, 23, 9], np.int32)])
def test_forward_matches_jax(params, valid):
    jp, pp = params
    ph, cond, x = _inputs(1)
    times = np.array([0.1, 0.5, 0.9], np.float32)
    drop = np.array([False, True, False])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JA.forward(jp, J_AC, jnp.asarray(x), jnp.asarray(ph), jnp.asarray(cond),
                                    jnp.asarray(times), cond_drop_mask=jnp.asarray(drop),
                                    valid_len=None if valid is None else jnp.asarray(valid)))
    out = PA.forward(pp, P_AC, torch.from_numpy(x), torch.from_numpy(ph), torch.from_numpy(cond),
                     torch.from_numpy(times), cond_drop_mask=torch.from_numpy(drop),
                     valid_len=None if valid is None else torch.from_numpy(valid)).numpy()
    assert np.abs(out - ref).max() < 2e-5


@pytest.mark.parametrize("cond_scale,valid", [
    (0.7, np.array([40, 23, 9], np.int32)),   # the serving path: CFG + per-row valid_len
    (0.7, 31),
    (1.0, None),
])
def test_sample_matches_jax(params, cond_scale, valid):
    jp, pp = params
    ph, cond, noise = _inputs(2)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JA.sample(jp, J_AC, jax.random.PRNGKey(0), jnp.asarray(ph), jnp.asarray(cond),
                                   cond_scale=cond_scale, valid_len=None if valid is None else jnp.asarray(valid),
                                   noise=jnp.asarray(noise)))
    out = PA.sample(pp, P_AC, None, torch.from_numpy(ph), torch.from_numpy(cond), cond_scale=cond_scale,
                    valid_len=None if valid is None else torch.as_tensor(valid),
                    noise=torch.from_numpy(noise)).numpy()
    assert out.shape == (B, T, 80)
    assert np.abs(out - ref).max() < 1e-4


def test_sample_bf16_runs_with_f32_state(params):
    """bf16 compute keeps the ODE state in f32 and stays close to f32."""
    _, pp = params
    ph, cond, noise = _inputs(3)
    args = (pp, P_AC, None, torch.from_numpy(ph), torch.from_numpy(cond))
    kw = dict(cond_scale=0.7, valid_len=torch.tensor([40, 30, 20]), noise=torch.from_numpy(noise))
    hi = PA.sample(*args, **kw)
    lo = PA.sample(*args, dtype=torch.bfloat16, **kw)
    assert lo.dtype == torch.float32 and torch.isfinite(lo).all()
    assert (lo - hi).abs().max().item() < 0.1


def test_sample_draws_noise_from_generator(params):
    _, pp = params
    ph, cond, _ = _inputs(4)
    run = lambda seed: PA.sample(pp, P_AC, torch.Generator().manual_seed(seed), torch.from_numpy(ph),
                                 torch.from_numpy(cond), cond_scale=0.7)
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def _pad(arr, tb, value):
    return np.pad(arr, [(0, 0), (0, tb - arr.shape[1])] + [(0, 0)] * (arr.ndim - 2), constant_values=value)


def test_key_mask_removes_padding_skew(params):
    """tests/test_bucket_skew.py's check on the port: bucket padding skews the
    valid frames unless `key_mask` zeroes the padded frames before the conv
    and masks them out of attention; the masked padded run matches the
    exact-length run, and JAX's masked padded run."""
    jp, pp = params
    t, tb = 29, 40
    rs = np.random.RandomState(5)
    x = rs.randn(B, t, 80).astype(np.float32)
    ph = rs.randint(0, 500, (B, t, 2)).astype(np.int32)
    cond = rs.randn(B, t, 160).astype(np.float32)
    times = np.array([0.2, 0.5, 0.8], np.float32)
    xp, php, cp = _pad(x, tb, 0.0), _pad(ph, tb, 501), _pad(cond, tb, 0.0)
    km = np.broadcast_to(np.arange(tb) < t, (B, tb)).copy()
    run = lambda *a, **kw: PA.forward(pp, P_AC, *(torch.from_numpy(v) for v in (*a, times)), **kw).numpy()
    exact = run(x, ph, cond)
    unmasked = run(xp, php, cp)[:, :t]
    masked = run(xp, php, cp, key_mask=torch.from_numpy(km))[:, :t]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JA.forward(jp, J_AC, jnp.asarray(xp), jnp.asarray(php), jnp.asarray(cp),
                                    jnp.asarray(times), key_mask=jnp.asarray(km)))[:, :t]
    assert np.abs(unmasked - exact).max() > 1e-3
    assert np.abs(masked - exact).max() < 1e-4
    assert np.abs(masked - ref).max() < 2e-5


def test_key_mask_takes_precedence_over_valid_len(params):
    """With both given, the key mask decides the conv's zeroing and the
    attention, as in JAX: a per-row mask with a contradicting valid_len."""
    jp, pp = params
    ph, cond, x = _inputs(6)
    times = np.array([0.3, 0.6, 0.9], np.float32)
    km = np.arange(T)[None, :] < np.array([[35], [17], [40]])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JA.forward(jp, J_AC, jnp.asarray(x), jnp.asarray(ph), jnp.asarray(cond),
                                    jnp.asarray(times), key_mask=jnp.asarray(km), valid_len=jnp.int32(5)))
    out = PA.forward(pp, P_AC, *(torch.from_numpy(v) for v in (x, ph, cond, times)),
                     key_mask=torch.from_numpy(km), valid_len=5).numpy()
    assert np.abs(out - ref).max() < 2e-5


@pytest.mark.parametrize("cond_scale", [0.7, 1.0])
def test_sample_with_key_mask_matches_jax(params, cond_scale):
    """`sample` with a per-row key mask (doubled for the CFG batch) against
    JAX's on the same noise."""
    jp, pp = params
    ph, cond, noise = _inputs(7)
    km = np.arange(T)[None, :] < np.array([[40], [26], [11]])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JA.sample(jp, J_AC, jax.random.PRNGKey(0), jnp.asarray(ph), jnp.asarray(cond),
                                   cond_scale=cond_scale, key_mask=jnp.asarray(km), noise=jnp.asarray(noise)))
    out = PA.sample(pp, P_AC, None, torch.from_numpy(ph), torch.from_numpy(cond), cond_scale=cond_scale,
                    key_mask=torch.from_numpy(km), noise=torch.from_numpy(noise)).numpy()
    assert np.abs(out - ref).max() < 1e-4
