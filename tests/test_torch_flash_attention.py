"""The port's flash-attention module against the JAX package.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it against
this plain version there). Here the plain version, which CPU tensors take, is
held against the JAX Pallas kernel in interpret mode, and the dispatcher's
choices are checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import layers as JL
from covomix_tpu.ops import flash_attention as JF
from covomix_tpu_torch.models import layers as PL
from covomix_tpu_torch.ops import flash_attention as PF

B, H, DH = 2, 2, 64
TOL = 2e-5   # f32 on both sides; the TPU kernel's one-shot softmax vs torch's reductions


def _qkv(t, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, t, DH).astype(np.float32) for _ in range(3)]


def _jax_flash(q, k, v, valid, rotary):
    tables = None
    if rotary:
        t = q.shape[2]
        tables = JF.rotary_tables_halfsplit(jnp.arange(t), JL.rotary_freqs(DH), jnp.float32)
    with jax.default_matmul_precision("highest"):
        return np.asarray(JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             valid_len=None if valid is None else jnp.asarray(valid),
                                             rotary=tables, interpret=True))


def _port_flash(q, k, v, valid, rotary):
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tables = None
    if rotary:
        t = q.shape[2]
        tables = PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(DH), torch.float32)
    vl = None if valid is None else torch.as_tensor(valid)
    return PF.flash_attention(tq, tk, tv, valid_len=vl, rotary=tables).numpy()


@pytest.mark.parametrize("t,rotary,valid", [
    (256, False, None),
    (256, True, np.array([256, 100], np.int32)),
    (256, False, np.int32(77)),
    (600, True, np.array([600, 333], np.int32)),
    (600, False, np.array([1, 600], np.int32)),
    (600, True, np.int32(600)),
])
def test_plain_matches_jax_flash(t, rotary, valid):
    q, k, v = _qkv(t, t + int(rotary))
    ref = _jax_flash(q, k, v, valid, rotary)
    out = _port_flash(q, k, v, valid, rotary)
    assert np.abs(out - ref).max() < TOL


# The forms the card's f32 forward at head dim 64 takes (chip_smoke.py holds
# it to flash_attention_plain there): T off the 64-key tile, per-row
# valid_len down to 1, with and without the logsumexp, causal or not,
# rotary or not.
F32_FORMS = [  # (T, valid_len, causal, lse, rotary)
    (130, np.array([130, 1], np.int32), False, False, False),
    (130, np.array([1, 77], np.int32), False, True, False),
    (193, np.array([193, 64], np.int32), True, True, False),
    (193, np.int32(1), True, False, True),
    (257, np.array([100, 257], np.int32), False, True, True),
    (257, np.array([257, 1], np.int32), True, True, False),
    (65, np.array([65, 1], np.int32), True, False, False),
    (65, np.int32(65), False, True, True),
]


@pytest.mark.parametrize("t,valid,causal,lse,rotary", F32_FORMS)
def test_plain_f32_forms_match_jax(t, valid, causal, lse, rotary):
    q, k, v = _qkv(t, 40 + t)
    cfg = (JF.DEFAULT_BLOCK_Q, JF.DEFAULT_BLOCK_K, JF.DEFAULT_HEAD_BLOCK, True, causal)
    jtab = JF.rotary_tables_halfsplit(jnp.arange(t), JL.rotary_freqs(DH), jnp.float32) if rotary else None
    ptab = PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(DH), torch.float32) if rotary else None
    with jax.default_matmul_precision("highest"):
        ref = JF._flash_forward(cfg, jnp.maximum(jnp.asarray(valid, jnp.int32).reshape(-1), 1), jnp.asarray(q),
                                jnp.asarray(k), jnp.asarray(v), with_lse=lse, rotary=jtab)
    out = PF.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), PF._valid_array(valid, B, t, "cpu"),
                                   ptab, causal=causal, return_lse=lse)
    if lse:
        (ref, ref_lse), (out, out_lse) = ref, out
        assert out_lse.shape == (B, H, t) and out_lse.dtype == torch.float32
        assert np.abs(out_lse.numpy() - np.asarray(ref_lse)[:, :, :t, 0]).max() < TOL
    assert out.shape == (B, H, t, DH) and out.dtype == torch.float32
    assert np.abs(out.numpy() - np.asarray(ref)[:, :, :t]).max() < TOL


def test_valid_len_zero_clamps_to_one():
    """valid_len 0 attends key 0 only (the -1e30 mask with the >= 1 clamp),
    exactly as the TPU kernel does; layers.attend would give zeros there."""
    q, k, v = _qkv(256, 5)
    valid = np.array([0, 128], np.int32)
    ref = _jax_flash(q, k, v, valid, False)
    out = _port_flash(q, k, v, valid, False)
    assert np.abs(out - ref).max() < TOL
    np.testing.assert_allclose(out[0], np.broadcast_to(v[0, :, :1], v[0].shape), atol=1e-6)


def test_rotary_tables_match_jax():
    t = 40
    jc, js = JF.rotary_tables_halfsplit(jnp.arange(t), JL.rotary_freqs(DH), jnp.float32)
    pc, ps = PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(DH), torch.float32)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)


def test_fused_rotary_equals_external_rotary():
    """In-kernel rotary == layers.rotary_halfsplit applied outside (f32)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(64, 9))
    pos, inv = torch.arange(64), PL.rotary_freqs(DH)
    tables = PF.rotary_tables_halfsplit(pos, inv, torch.float32)
    fused = PF.flash_attention(q, k, v, rotary=tables)
    ext = PF.flash_attention(PL.rotary_halfsplit(pos, inv, q), PL.rotary_halfsplit(pos, inv, k), v)
    assert (fused - ext).abs().max().item() < 1e-5


@pytest.mark.parametrize("kw,expect", [
    (dict(on_cuda=True, tq=912, tk=912, dh=64, has_key_mask=False, causal=False), True),
    (dict(on_cuda=False, tq=912, tk=912, dh=64, has_key_mask=False, causal=False), False),
    (dict(on_cuda=True, tq=511, tk=511, dh=64, has_key_mask=False, causal=False), False),
    (dict(on_cuda=True, tq=512, tk=512, dh=64, has_key_mask=True, causal=False), False),
    (dict(on_cuda=True, tq=912, tk=912, dh=320, has_key_mask=False, causal=False), False),
    (dict(on_cuda=True, tq=912, tk=912, dh=256, has_key_mask=False, causal=False), True),
    (dict(on_cuda=True, tq=912, tk=912, dh=48, has_key_mask=False, causal=False), True),
    (dict(on_cuda=True, tq=912, tk=912, dh=40, has_key_mask=False, causal=False), False),
    (dict(on_cuda=True, tq=600, tk=900, dh=64, has_key_mask=False, causal=True), False),
    (dict(on_cuda=True, tq=600, tk=600, dh=64, has_key_mask=False, causal=True), True),
])
def test_dispatch_rule(kw, expect):
    """The JAX rule with 'on TPU' read as 'on CUDA' (flash_attention.py:759-761)
    and dh <= 256 read as the head dims the kernel is built for (multiples of
    16 up to 256)."""
    assert PF.use_flash_kernel(**kw) is expect
    assert PF.kernel_supports_dh(kw["dh"]) is (kw["dh"] % 16 == 0 and kw["dh"] <= 256)


def test_kernel_build_refuses_head_dims_outside_the_rule():
    """The build raises before nvcc for a head dim the dispatcher never sends."""
    for dh in (8, 40, 272):
        with pytest.raises(NotImplementedError, match="multiples of 16"):
            PF.KERNEL.build(dh)


def test_dispatcher_on_cpu_matches_jax_dispatcher():
    """On the CPU both packages take the einsum path with valid_len as a key
    mask and rotary applied outside."""
    q, k, v = _qkv(600, 3)
    valid = np.array([600, 321], np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JF.attend_flash_or_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid_len=jnp.asarray(valid),
            rotary=(jnp.arange(600), JL.rotary_freqs(DH))))
    out = PF.attend_flash_or_xla(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 valid_len=torch.from_numpy(valid),
                                 rotary=(torch.arange(600), PL.rotary_freqs(DH))).numpy()
    assert np.abs(out - ref).max() < TOL


def test_causal_form_runs_and_matches_jax():
    """The causal form (T2S training) runs, with and without grad, and equals
    the JAX kernel in interpret mode (its gradients:
    tests/test_torch_flash_backward.py); what the JAX package refuses, causal
    with tq != tk, raises."""
    q, k, v = _qkv(600, 11)
    valid = np.array([600, 433], np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            valid_len=jnp.asarray(valid), causal=True, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = PF.flash_attention(tq, tk, tv, valid_len=torch.from_numpy(valid), causal=True)
    assert out.grad_fn is None and np.abs(out.numpy() - ref).max() < TOL
    out = PF.flash_attention(tq.clone().requires_grad_(), tk, tv, valid_len=torch.from_numpy(valid), causal=True)
    assert type(out.grad_fn).__name__ == "_FlashCoreBackward"
    assert np.abs(out.detach().numpy() - ref).max() < TOL
    with pytest.raises(ValueError, match="tq == tk"):
        PF.flash_attention(tq, tk[:, :, :500], tv[:, :, :500], causal=True)


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The wrapper launches the kernel or raises; it never computes on the CPU."""
    q = torch.zeros(1, 1, 8, 64)
    before = PF.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL(q, q, q, torch.ones(1, dtype=torch.int32))
    assert PF.KERNEL.launches == before


def test_plain_version_keeps_bf16_output_type():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(32, 4))
    out = PF.flash_attention(q, k, v, valid_len=20)
    ref = PF.flash_attention(q.float(), k.float(), v.float(), valid_len=20)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 2e-2   # p and out rounded to bf16


def test_rotary_prepass_takes_only_cuda_tensors():
    """The rotary pre-pass launches its kernel or raises, like the forward;
    a refused call counts no launch."""
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    tables = PF.rotary_tables_halfsplit(torch.arange(8), PL.rotary_freqs(64), torch.bfloat16)
    before = (PF.KERNEL.rotary_launches, PF.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL.rotary(q, q, *tables)
    with pytest.raises(ValueError, match="CUDA"):
        PF.KERNEL(q, q, q, torch.ones(1, dtype=torch.int32), tables)
    assert (PF.KERNEL.rotary_launches, PF.KERNEL.launches) == before


def test_bf16_rotary_forward_is_plain_rotation_then_attention():
    """On the card a bf16 forward with tables is the pre-pass (`_rotary_plain`'s
    arithmetic) then the attention kernel on the rotated q and k; the plain
    version is that composition, bit for bit, output and lse."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(96, 12))
    valid = PF._valid_array(torch.tensor([96, 40]), B, 96, "cpu")
    cos, sin = PF.rotary_tables_halfsplit(torch.arange(96), PL.rotary_freqs(DH), torch.bfloat16)
    out, lse = PF.flash_attention_plain(q, k, v, valid, (cos, sin), return_lse=True)
    ref, ref_lse = PF.flash_attention_plain(PF._rotary_plain(q, cos, sin), PF._rotary_plain(k, cos, sin), v, valid,
                                            return_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


@pytest.mark.parametrize("dh", [dh for dh in range(16, PF.MAX_DH + 1, 16) if PF.kernel_supports_dh(dh)])
def test_rotary_plain_and_transpose_match_jax(dh):
    """At every head dim the rotary pre-pass is built for, its plain version
    (`_rotary_plain`, which the pre-pass equals bit for bit on the card and
    the backward re-rotates with) and the backward's counter-rotation equal
    the JAX package's `_rotary_xla` and `_rotary_xla_transpose` (f32)."""
    t = 24
    rs = np.random.RandomState(dh)
    x, g = (rs.randn(B, H, t, dh).astype(np.float32) for _ in range(2))
    jc, js = JF.rotary_tables_halfsplit(jnp.arange(t), JL.rotary_freqs(dh), jnp.float32)
    pc, ps = PF.rotary_tables_halfsplit(torch.arange(t), PL.rotary_freqs(dh), torch.float32)
    out = PF._rotary_plain(torch.from_numpy(x), pc, ps).numpy()
    np.testing.assert_allclose(out, np.asarray(JF._rotary_xla(jnp.asarray(x), jc, js)), atol=1e-5)
    back = PF._rotary_transpose(torch.from_numpy(g), pc, ps).numpy()
    np.testing.assert_allclose(back, np.asarray(JF._rotary_xla_transpose(jnp.asarray(g), jc, js)), atol=1e-5)
