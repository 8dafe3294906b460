"""The training form of the port's flash attention against the JAX package.

The CUDA kernels run only on the card (chip_smoke.py holds them against these
plain versions there). Here, on CPU tensors, the plain forward's logsumexp is
held against `_flash_forward(..., with_lse=True)` in interpret mode, and the
gradients through the port's autograd Functions (`_FlashCore`,
`_FlashCoreRot`, with the plain versions) against `jax.grad` through the
Pallas `flash_attention(interpret=True)`, in the non-causal form and in the
causal one (the T2S training decoder's). f32 on both sides at 'highest'
precision: the two differ only in summation order, so gradients agree to
about 1e-5 of their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread beside the XLA client)
from covomix_tpu.models import layers as JL
from covomix_tpu.ops import flash_attention as JF
from covomix_tpu_torch.models import layers as PL
from covomix_tpu_torch.ops import flash_attention as PF

B, H, DH = 2, 2, 16
FWD_TOL = 2e-5    # the Pallas kernel's softmax vs torch's reductions, f32
GRAD_TOL = 1e-5   # x max(1, max |JAX grad|)


def _arrays(t, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, t, DH).astype(np.float32) for _ in range(n)]


def _tables(t, jax_side):
    if jax_side:
        return JF.rotary_tables_halfsplit(jnp.arange(t), JL.rotary_freqs(DH), jnp.float32)
    return PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(DH), torch.float32)


CASES = [  # (T, valid_len, rotary): scalar and [B] valid_len, rotary on/off, T off the 64-grid
    (256, None, True),
    (200, np.array([200, 77], np.int32), True),
    (192, np.int32(150), False),
    (330, np.array([1, 330], np.int32), False),
    (600, np.int32(600), True),
]


CAUSAL_CASES = [  # (T, valid_len, rotary): the causal form; T = 513 leaves one row in the last 64-tile
    (513, None, False),
    (513, np.array([513, 300], np.int32), True),
    (600, np.int32(450), False),
    (600, np.array([600, 1], np.int32), True),
]


def _check_lse(t, valid, rotary, causal):
    q, k, v, _ = _arrays(t, t)
    vl = t if valid is None else valid
    cfg = (JF.DEFAULT_BLOCK_Q, JF.DEFAULT_BLOCK_K, JF.DEFAULT_HEAD_BLOCK, True, causal)
    with jax.default_matmul_precision("highest"):
        out_j, lse_j = JF._flash_forward(cfg, jnp.maximum(jnp.asarray(vl, jnp.int32).reshape(-1), 1),
                                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), with_lse=True,
                                         rotary=_tables(t, True) if rotary else None)
    out_p, lse_p = PF.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                            PF._valid_array(vl, B, t, "cpu"),
                                            _tables(t, False) if rotary else None, return_lse=True, causal=causal)
    assert lse_p.shape == (B, H, t) and lse_p.dtype == torch.float32
    assert np.abs(lse_p.numpy() - np.asarray(lse_j)[..., 0]).max() < FWD_TOL
    assert np.abs(out_p.numpy() - np.asarray(out_j)).max() < FWD_TOL


@pytest.mark.parametrize("t,valid,rotary", CASES)
def test_plain_lse_matches_jax(t, valid, rotary):
    _check_lse(t, valid, rotary, False)


@pytest.mark.parametrize("t,valid,rotary", CAUSAL_CASES)
def test_causal_plain_lse_matches_jax(t, valid, rotary):
    _check_lse(t, valid, rotary, True)


def _check_gradients(t, valid, rotary, causal):
    """d/d(q, k, v) of sum(out * w) through the port's autograd Functions
    (plain versions on the CPU) against jax.grad through the Pallas kernels."""
    q, k, v, w = _arrays(t, 10 + t)

    def jax_loss(q, k, v):
        out = JF.flash_attention(q, k, v, valid_len=None if valid is None else jnp.asarray(valid), causal=causal,
                                 rotary=_tables(t, True) if rotary else None, interpret=True)
        return jnp.sum(out * w)

    with jax.default_matmul_precision("highest"):
        ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = PF.flash_attention(*leaves, valid_len=None if valid is None else torch.as_tensor(valid), causal=causal,
                             rotary=_tables(t, False) if rotary else None)
    expect = PF._FlashCoreRot if rotary else PF._FlashCore
    assert type(out.grad_fn).__name__ == f"{expect.__name__}Backward"
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, r in zip(leaves, ref):
        r = np.asarray(r)
        assert np.abs(leaf.grad.numpy() - r).max() <= GRAD_TOL * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("t,valid,rotary", CASES)
def test_gradients_match_jax_grad(t, valid, rotary):
    _check_gradients(t, valid, rotary, False)


@pytest.mark.parametrize("t,valid,rotary", CAUSAL_CASES)
def test_causal_gradients_match_jax_grad(t, valid, rotary):
    _check_gradients(t, valid, rotary, True)


def _check_plain_backward(rotary, causal):
    """The hand-derived backward (flash_attention_bwd_plain, with the rotary
    transpose) against torch autograd through the plain forward, f32."""
    t = 150
    q, k, v, w = (torch.from_numpy(x) for x in _arrays(t, 5))
    valid = PF._valid_array(torch.tensor([150, 61]), B, t, "cpu")
    tables = _tables(t, False) if rotary else None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (PF.flash_attention_plain(*leaves, valid, tables, causal=causal) * w).sum().backward()
    qr, kr = (PF._rotary_plain(x, *tables) for x in (q, k)) if rotary else (q, k)
    out, lse = PF.flash_attention_plain(qr, kr, v, valid, return_lse=True, causal=causal)
    dq, dk, dv = PF.flash_attention_bwd_plain(qr, kr, v, out, lse, w, valid, causal)
    if rotary:
        dq, dk = PF._rotary_transpose(dq, *tables), PF._rotary_transpose(dk, *tables)
    for mine, leaf in zip((dq, dk, dv), leaves):
        assert (mine - leaf.grad).abs().max().item() < 1e-5
    # key rows past valid_len get exact zeros
    assert bool((dk[1, :, 61:] == 0).all()) and bool((dv[1, :, 61:] == 0).all())
    return dq, dk, dv


@pytest.mark.parametrize("rotary", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(rotary):
    _check_plain_backward(rotary, False)


@pytest.mark.parametrize("rotary", [False, True])
def test_causal_plain_backward_matches_autograd_of_plain_forward(rotary):
    """The same with causal. Row 0's last key (149) is seen by query 149
    alone, and still takes a gradient."""
    _, dk, dv = _check_plain_backward(rotary, True)
    assert bool((dk[0, :, -1] != 0).all()) and bool((dv[0, :, -1] != 0).all())


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_with_tables_is_the_rotary_transpose(causal):
    """dQ and dK with the rotary tables are `_rotary_transpose` of dQ and dK
    without them, bit for bit (the kernels' epilogue is held to the same
    on the card); dV does not change. bf16, as the kernels take tables."""
    t = 200
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in _arrays(t, 21))
    valid = PF._valid_array(torch.tensor([200, 97]), B, t, "cpu")
    tables = tuple(x.to(torch.bfloat16) for x in _tables(t + 16, False))   # longer than T, as the kernel takes
    out, lse = PF.flash_attention_plain(q, k, v, valid, return_lse=True, causal=causal)
    delta = PF.flash_delta(g, out)
    args = (q, k, v, g, lse, delta, valid, causal)
    cos, sin = tables[0][:t], tables[1][:t]
    assert torch.equal(PF.flash_bwd_dq_plain(*args, rotary=tables),
                       PF._rotary_transpose(PF.flash_bwd_dq_plain(*args), cos, sin))
    (dk_r, dv_r), (dk, dv) = PF.flash_bwd_dkv_plain(*args, rotary=tables), PF.flash_bwd_dkv_plain(*args)
    assert torch.equal(dk_r, PF._rotary_transpose(dk, cos, sin)) and torch.equal(dv_r, dv)


def test_rotary_backward_reads_the_saved_rotated_pair(monkeypatch):
    """`_FlashCoreRot` rotates q and k once, in its forward; its backward
    re-rotates nothing and hands the tables to the backward, whose rotary
    transpose runs once for dq and once for dk."""
    calls = {"rotate": 0, "transpose": 0}
    rotate, transpose = PF._rotary_plain, PF._rotary_transpose

    def spy_rotate(*a):
        calls["rotate"] += 1
        return rotate(*a)

    def spy_transpose(*a):
        calls["transpose"] += 1
        return transpose(*a)

    monkeypatch.setattr(PF, "_rotary_plain", spy_rotate)
    monkeypatch.setattr(PF, "_rotary_transpose", spy_transpose)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays(96, 4, 3))
    out = PF.flash_attention(q, k, v, rotary=_tables(96, False))
    assert type(out.grad_fn).__name__ == "_FlashCoreRotBackward" and calls == {"rotate": 2, "transpose": 0}
    out.sum().backward()
    assert calls == {"rotate": 2, "transpose": 2}


def test_no_grad_runs_the_forward_without_lse(monkeypatch):
    """Under torch.no_grad (inference) the forward without the logsumexp
    runs; with grad on and an input that requires it, the lse forward inside
    the autograd Function."""
    calls = []
    plain = PF.flash_attention_plain

    def spy(*args, return_lse=False):
        calls.append(return_lse)
        return plain(*args, return_lse=return_lse)

    monkeypatch.setattr(PF, "flash_attention_plain", spy)
    q, k, v = (torch.from_numpy(x) for x in _arrays(64, 3, 3))
    tables = _tables(64, False)
    with torch.no_grad():
        out = PF.flash_attention(q.requires_grad_(), k, v, rotary=tables)
    assert out.grad_fn is None and calls == [False]
    out = PF.flash_attention(q.detach(), k, v, rotary=tables)     # nothing requires grad
    assert out.grad_fn is None and calls == [False, False]
    out = PF.flash_attention(q.detach().requires_grad_(), k, v, rotary=tables)
    assert out.grad_fn is not None and calls == [False, False, True]


def _counts():
    k = PF.KERNEL
    return (k.launches, k.lse_launches, k.dq_launches, k.dkv_launches, k.causal_launches, k.causal_lse_launches,
            k.causal_dq_launches, k.causal_dkv_launches)


def _refuse_cpu_tensors(causal):
    q = torch.zeros(1, 1, 8, 64)
    rows = torch.zeros(1, 1, 8)
    valid = torch.ones(1, dtype=torch.int32)
    counts = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL.bwd_dq(q, q, q, q, rows, rows, valid, causal=causal)
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL.bwd_dkv(q, q, q, q, rows, rows, valid, causal=causal)
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL(q, q, q, valid, return_lse=True, causal=causal)
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL(q, q, q, valid, causal=causal)
    assert counts == _counts()


def test_backward_wrappers_take_only_cuda_tensors():
    """The backward wrappers launch their kernel or raise; they never compute
    on the CPU, and a refused call counts no launch."""
    _refuse_cpu_tensors(False)


def test_causal_wrappers_take_only_cuda_tensors():
    """The same for the causal form of the three kernels."""
    _refuse_cpu_tensors(True)


F32_DH = PF.F32_TILE_DH
F32_FORMS = [  # (T, valid_len, causal, rotary) at head dim 64: T off the 64-row tile, valid_len 1 and ragged [B]
    (100, None, False, True),
    (130, np.array([130, 1], np.int32), False, True),
    (130, np.array([97, 130], np.int32), False, False),
    (100, np.int32(1), False, False),
    (130, None, True, False),
    (100, np.array([100, 61], np.int32), True, True),
    (130, np.array([1, 130], np.int32), True, False),
]


@pytest.mark.parametrize("t,valid,causal,rotary", F32_FORMS)
def test_plain_f32_backward_forms_match_jax(t, valid, causal, rotary):
    """The f32 dh-64 backward forms the tiled kernels take (the plain versions
    `flash_bwd_dq_plain` / `flash_bwd_dkv_plain` with the rotary tables, and
    the autograd Functions) against jax.grad through the Pallas
    flash_attention(interpret=True)."""
    rs = np.random.RandomState(70 + t)
    q, k, v, w = (rs.randn(B, H, t, F32_DH).astype(np.float32) for _ in range(4))
    jtab = JF.rotary_tables_halfsplit(jnp.arange(t), JL.rotary_freqs(F32_DH), jnp.float32) if rotary else None
    ptab = PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(F32_DH), torch.float32) if rotary else None

    def jax_loss(q, k, v):
        out = JF.flash_attention(q, k, v, valid_len=None if valid is None else jnp.asarray(valid), causal=causal,
                                 rotary=jtab, interpret=True)
        return jnp.sum(out * w)

    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(r) for r in jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    tol = [GRAD_TOL * max(1.0, np.abs(r).max()) for r in ref]
    # the plain versions as the kernels are called: rotated q and k, the tables
    qt, kt, vt, wt = (torch.from_numpy(x) for x in (q, k, v, w))
    vl = PF._valid_array(t if valid is None else valid, B, t, "cpu")
    qr, kr = (PF._rotary_plain(x, *ptab) for x in (qt, kt)) if rotary else (qt, kt)
    out, lse = PF.flash_attention_plain(qr, kr, vt, vl, causal=causal, return_lse=True)
    args = (qr, kr, vt, wt, lse, PF.flash_delta(wt, out), vl, causal)
    dq = PF.flash_bwd_dq_plain(*args, rotary=ptab)
    dk, dv = PF.flash_bwd_dkv_plain(*args, rotary=ptab)
    for mine, r, bound in zip((dq, dk, dv), ref, tol):
        assert mine.dtype == torch.float32 and np.abs(mine.numpy() - r).max() <= bound
    # the autograd Function
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    out = PF.flash_attention(*leaves, valid_len=None if valid is None else torch.as_tensor(valid), causal=causal,
                             rotary=ptab)
    (out * wt).sum().backward()
    for leaf, r, bound in zip(leaves, ref, tol):
        assert np.abs(leaf.grad.numpy() - r).max() <= bound


@pytest.mark.parametrize("dtype,dh,in_kernel", [(torch.float32, F32_DH, True), (torch.bfloat16, F32_DH, True),
                                                 (torch.float32, 32, False)])
def test_cuda_backward_hands_the_tables_to_the_kernels(monkeypatch, dtype, dh, in_kernel):
    """On CUDA tensors `_backward` hands the rotary tables to `KERNEL.bwd_dq`
    / `bwd_dkv` where the kernels take them (bf16, and f32 at head dim 64) and
    then runs no `_unrotate`; after the f32 kernels of the other head dims it
    counter-rotates dq and dk in PyTorch. The wrappers and the device are
    stood in for (CPU tensors reporting CUDA; the spies return the plain
    versions)."""
    seen, unrotated = [], []
    transpose, dq_plain, dkv_plain = PF._rotary_transpose, PF.flash_bwd_dq_plain, PF.flash_bwd_dkv_plain
    in_spy = [False]

    def spy_transpose(*a):
        if not in_spy[0]:
            unrotated.append(tuple(a[0].shape))
        return transpose(*a)

    def spy(name, plain):
        def wrapper(q, k, v, dout, lse, delta, valid, causal=False, rotary=None):
            seen.append((name, rotary is not None))
            in_spy[0] = True
            try:
                return plain(q, k, v, dout, lse, delta, valid, causal, rotary)
            finally:
                in_spy[0] = False
        return wrapper

    t = 70
    rs = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rs.randn(B, H, t, dh).astype(np.float32)).to(dtype) for _ in range(4))
    tables = PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(dh), dtype)
    valid = PF._valid_array(t, B, t, "cpu")
    qr, kr = PF._rotary_plain(q, *tables), PF._rotary_plain(k, *tables)
    out, lse = PF.flash_attention_plain(qr, kr, v, valid, return_lse=True)
    expect = PF._backward(qr, kr, v, out, lse, g, valid, False, tables)   # CPU: the plain version
    monkeypatch.setattr(PF.KERNEL, "bwd_dq", spy("dq", dq_plain))
    monkeypatch.setattr(PF.KERNEL, "bwd_dkv", spy("dkv", dkv_plain))
    monkeypatch.setattr(PF, "_rotary_transpose", spy_transpose)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    got = PF._backward(qr, kr, v, out, lse, g, valid, False, tables)
    monkeypatch.undo()
    assert PF.backward_takes_tables(q) == in_kernel
    assert seen == [("dq", in_kernel), ("dkv", in_kernel)]
    assert unrotated == ([] if in_kernel else [(B, H, t, dh)] * 2)   # `_unrotate` of dq and dk after the kernels
    for a, b in zip(got, expect):
        assert torch.equal(a, b)

