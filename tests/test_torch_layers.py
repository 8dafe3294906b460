"""The port's layer primitives and sampling ops against the JAX package, on
the same numpy inputs. f32 on both sides under 'highest' matmul precision:
the tolerances cover summation order only (1e-5 on O(1) values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import layers as JL
from covomix_tpu.ops import sampling as JS
from covomix_tpu_torch.models import layers as PL
from covomix_tpu_torch.ops import sampling as PS

TOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(port, ref, tol=TOL):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float32)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= tol


def _p(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def test_linear_and_embedding():
    p = {"w": _rand(12, 7, seed=1), "b": _rand(7, seed=2)}
    x = _rand(2, 5, 12, seed=3)
    _close(PL.linear(_p(p), torch.from_numpy(x)), JL.linear(_j(p), jnp.asarray(x)))
    e = {"w": _rand(30, 6, seed=4)}
    ids = np.random.RandomState(5).randint(0, 30, (3, 4)).astype(np.int32)
    _close(PL.embedding(_p(e), torch.from_numpy(ids)), JL.embedding(_j(e), jnp.asarray(ids)))


@pytest.mark.parametrize("padding,groups,dilation,stride", [
    ("SAME", 1, 1, 1), (3, 1, 1, 1), ((2, 4), 1, 1, 1), (6, 1, 3, 1), ("VALID", 1, 1, 2), ("SAME", 4, 1, 1),
])
def test_conv1d(padding, groups, dilation, stride):
    k, cin, cout = 5, 8, 12
    p = {"w": _rand(k, cin // groups, cout, seed=1), "b": _rand(cout, seed=2)}
    x = _rand(2, 19, cin, seed=3)
    ref = JL.conv1d(_j(p), jnp.asarray(x), stride=stride, padding=padding, groups=groups, rhs_dilation=dilation)
    out = PL.conv1d(_p(p), torch.from_numpy(x), stride=stride, padding=padding, groups=groups,
                    rhs_dilation=dilation)
    _close(out, ref)


def test_depthwise_conv1d():
    p = {"w": _rand(31, 1, 16, seed=1), "b": _rand(16, seed=2)}
    x = _rand(2, 40, 16, seed=3)
    _close(PL.depthwise_conv1d(_p(p), torch.from_numpy(x), padding=15),
           JL.depthwise_conv1d(_j(p), jnp.asarray(x), padding=15))


@pytest.mark.parametrize("stride,kernel", [(5, 8), (4, 8), (4, 4), (2, 4), (1, 3)])
def test_conv_transpose1d(stride, kernel):
    padding = (kernel - stride) // 2
    p = {"w": _rand(kernel, 6, 5, seed=1), "b": _rand(5, seed=2)}
    x = _rand(2, 11, 6, seed=3)
    ref = JL.conv_transpose1d(_j(p), jnp.asarray(x), stride=stride, padding=padding, kernel=kernel)
    out = PL.conv_transpose1d(_p(p), torch.from_numpy(x), stride=stride, padding=padding, kernel=kernel)
    assert out.shape[1] == (11 - 1) * stride - 2 * padding + kernel
    _close(out, ref)


def test_rmsnorm_and_l2_floor():
    """All-zero rows stay finite (the 1e-24 floor on the sum of squares)."""
    p = {"gamma": _rand(16, seed=1)}
    x = _rand(2, 5, 16, seed=2)
    x[0, 0] = 0.0
    out = PL.rmsnorm(_p(p), torch.from_numpy(x))
    _close(out, JL.rmsnorm(_j(p), jnp.asarray(x)))
    assert torch.isfinite(out).all() and (out[0, 0] == 0).all()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert PL.rmsnorm(_p(p), xb).dtype == torch.bfloat16   # computed in f32, returned in x's type


def test_adaptive_rmsnorm():
    p = {"to_gamma": {"w": _rand(8, 16, seed=1), "b": _rand(16, seed=2)},
         "to_beta": {"w": _rand(8, 16, seed=3), "b": _rand(16, seed=4)}}
    x, cond = _rand(2, 5, 16, seed=5), _rand(2, 8, seed=6)
    _close(PL.adaptive_rmsnorm(_p(p), torch.from_numpy(x), torch.from_numpy(cond)),
           JL.adaptive_rmsnorm(_j(p), jnp.asarray(x), jnp.asarray(cond)), tol=3e-5)


@pytest.mark.parametrize("kind", ["halfsplit", "interleaved"])
def test_rotary(kind):
    t = _rand(2, 3, 20, 16, seed=1)
    pos = np.arange(20)
    jf = getattr(JL, f"rotary_{kind}")
    pf = getattr(PL, f"rotary_{kind}")
    _close(pf(torch.from_numpy(pos), PL.rotary_freqs(16), torch.from_numpy(t)),
           jf(jnp.asarray(pos), JL.rotary_freqs(16), jnp.asarray(t)))


@pytest.mark.parametrize("mask,causal", [(False, False), (True, False), (False, True), (True, True)])
def test_attend(mask, causal):
    q, k, v = _rand(2, 2, 6, 16, seed=1), _rand(2, 2, 9, 16, seed=2), _rand(2, 2, 9, 16, seed=3)
    km = None
    if mask:
        km = np.ones((2, 9), bool)
        km[1] = False          # a fully masked row: zeros, not NaN
        km[0, 5:] = False
    ref = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_mask=None if km is None else jnp.asarray(km), causal=causal)
    out = PL.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    key_mask=None if km is None else torch.from_numpy(km), causal=causal)
    _close(out, ref)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("q_offset", [None, 0, 2, 5])
def test_attend_q_offset(q_offset):
    """Causal attention with the queries placed at key position q_offset
    (None: at the end of the key axis, here 5); q_offset 0 leaves the first
    query one key."""
    q, k, v = _rand(2, 2, 4, 16, seed=4), _rand(2, 2, 9, 16, seed=5), _rand(2, 2, 9, 16, seed=6)
    km = np.ones((2, 9), bool)
    km[1, 7:] = False
    ref = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask=jnp.asarray(km), causal=True,
                    q_offset=q_offset)
    out = PL.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), key_mask=torch.from_numpy(km),
                    causal=True, q_offset=q_offset)
    _close(out, ref)
    if q_offset == 0:
        _close(out[:, :, 0], np.broadcast_to(v[:, :, :1], (2, 2, 1, 16))[:, :, 0])


def test_split_merge_heads():
    x = _rand(2, 7, 12, seed=1)
    s = PL.split_heads(torch.from_numpy(x), 3)
    _close(s, JL.split_heads(jnp.asarray(x), 3))
    _close(PL.merge_heads(s), x, tol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_dtype_rule(dtype):
    """erf under f32, tanh approximation under bf16 — as the JAX package."""
    x = _rand(4, 64, seed=1, scale=3)
    jx = jnp.asarray(x).astype(dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    # bf16: the two frameworks round intermediates at different places. gelu:
    # one bf16 ulp (2^-7 relative, 2^-7 absolute near 0); geglu multiplies
    # that by the other half (|a| up to ~9 here), hence 2^-5 absolute
    f32 = dtype == "float32"
    for pf, jf, atol in ((PL.gelu, JL.gelu, 2.0 ** -7), (PL.geglu, JL.geglu, 2.0 ** -5)):
        np.testing.assert_allclose(pf(px).float().numpy(), np.asarray(jf(jx).astype(jnp.float32)),
                                   rtol=1e-5 if f32 else 2.0 ** -7, atol=1e-5 if f32 else atol)
    if dtype == "float32":  # the two formulas differ measurably at |x| ~ 2.7
        tanh = torch.nn.functional.gelu(px, approximate="tanh")
        assert (PL.gelu(px) - tanh).abs().max().item() > 1e-4


def test_leaky_relu():
    x = _rand(3, 10, seed=1)
    for slope in (0.01, 0.1):
        _close(PL.leaky_relu(torch.from_numpy(x), slope), JL.leaky_relu(jnp.asarray(x), slope), tol=0)


# ---------------------------------------------------------------------------
# sampling ops


def test_top_k_filter_keeps_ties():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 0.5], [5.0, 4.0, 3.0, 2.0, 1.0]], np.float32)
    for k in (1, 2, 3):
        out = PS.top_k_filter(torch.from_numpy(logits), k=k).numpy()
        np.testing.assert_array_equal(out, np.asarray(JS.top_k_filter(jnp.asarray(logits), k=k)))
    assert (PS.top_k_filter(torch.from_numpy(logits), k=1)[0] > -1).sum() == 2   # the tie survives
    big = _rand(3, 502, seed=2)
    np.testing.assert_array_equal(PS.top_k_filter(torch.from_numpy(big), thres=0.1).numpy(),
                                  np.asarray(JS.top_k_filter(jnp.asarray(big), thres=0.1)))


@pytest.mark.parametrize("thres", [0.3, 0.9, 0.99])
def test_top_p_filter(thres):
    """Nucleus filter: equal to JAX's (the crossing token kept, the rest
    NEG_INF), on spread and on peaked logits."""
    logits = np.concatenate([_rand(3, 502, seed=7, scale=2.0), _rand(1, 502, seed=8, scale=0.1)])
    logits[3, 17] = 12.0                  # one token holds nearly all the mass
    out = PS.top_p_filter(torch.from_numpy(logits), thres=thres).numpy()
    np.testing.assert_array_equal(out, np.asarray(JS.top_p_filter(jnp.asarray(logits), thres=thres)))
    kept = out > PS.NEG_INF
    assert kept[3].sum() == 1 and kept[3, 17] and (kept.sum(-1) >= 1).all()


def test_mask_after_eos_and_set_eos_id():
    toks = np.array([[3, 9, 4, 9, 2], [1, 2, 3, 4, 5], [9, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(PS.mask_after_eos(torch.from_numpy(toks), 9, -1).numpy(),
                                  np.asarray(JS.mask_after_eos(jnp.asarray(toks), 9, -1)))
    ids = np.array([[5, 6, 0, 0], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    out = PS.set_eos_id(torch.from_numpy(ids), 99, 0).numpy()
    np.testing.assert_array_equal(out, np.asarray(JS.set_eos_id(jnp.asarray(ids), 99, 0)))
    assert out.shape == (3, 5)


@pytest.mark.parametrize("n,cur_len", [(2, 6), (3, 8), (3, 2), (1, 4)])
def test_ban_repeated_ngrams(n, cur_len):
    toks = np.array([[1, 2, 1, 2, 1, 3, 1, 2, -1, -1], [4, 4, 4, 4, 5, 4, 4, 4, -1, -1]], np.int32)
    logits = _rand(2, 8, seed=3)
    ref = JS.ban_repeated_ngrams(jnp.asarray(logits), jnp.asarray(toks), jnp.int32(cur_len), n)
    out = PS.ban_repeated_ngrams(torch.from_numpy(logits), torch.from_numpy(toks), cur_len, n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gumbel_sample_from_generator():
    """Reproducible from the torch.Generator; argmax when one logit dominates."""
    logits = torch.from_numpy(_rand(4, 50, seed=1))
    a = PS.gumbel_sample(torch.Generator().manual_seed(3), logits)
    b = PS.gumbel_sample(torch.Generator().manual_seed(3), logits)
    assert torch.equal(a, b)
    filtered = PS.top_k_filter(logits, k=1)
    assert torch.equal(PS.gumbel_sample(torch.Generator().manual_seed(4), filtered), logits.argmax(-1))
    np.testing.assert_allclose(PS.safe_log(torch.tensor([0.0, 1.0])).numpy(),
                               np.asarray(JS.safe_log(jnp.asarray([0.0, 1.0]))), rtol=1e-6)
