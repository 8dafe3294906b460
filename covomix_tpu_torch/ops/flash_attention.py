"""Flash attention, forward and backward (port of covomix_tpu/ops/flash_attention.py).

On CUDA tensors the work runs in the hand-written Hopper kernels of
`csrc/flash_attention.cu` (built with nvcc at first use into
`covomix_tpu_torch/_build/`, bound with ctypes): the forward, with or without
the per-row logsumexp the backward reads, and the dQ and dK/dV backward
kernels, each non-causal or causal. On CPU tensors the same arithmetic runs in
plain PyTorch (`flash_attention_plain`, `flash_bwd_dq_plain`,
`flash_bwd_dkv_plain`): dead keys (past `valid_len`, and with `causal` past
the query row) set to -1e30 before the exp, `valid_len` clamped to >= 1, the
output divided by max(l, 1e-30), p and ds rounded to the input type before
their products. There is no fallback from one to the other.

The bf16 forward (`FlashKernel.__call__`), against what held its first
version back:
- rotary runs once per call, in its own pre-pass kernel (`FlashKernel.rotary`,
  `_rotary_plain`'s arithmetic bit for bit, counted in `rotary_launches`),
  not once per key tile in every query block;
- at head dims 64 and 128 (`WgCfg` in the source, whose static_asserts
  hold the tiles to the card's limits) the K/V tiles come through a ring of
  three (dh 64) or two shared-memory stages, loaded by TMA from a producer
  warp while the consumer warpgroup's products run;
- both products are wgmma (S = Q K^T from shared memory; O += P V with P in
  registers and V read in its natural layout: no transposed, bank-conflicted
  V copy);
- each block is one warpgroup of 64 query rows with 128-key tiles (dh 64),
  two blocks per SM; a tile's softmax runs under the previous tile's P V.
The other head dims keep the mma.sync forward. At the repo's shapes the
forward is bound by the tensor cores' operations, the causal form by its
bytes. The f32 forward rotates inside its kernel.

`flash_attention` is differentiable. With grad enabled and an input that
requires it, it runs a `torch.autograd.Function` (`_FlashCore`, or
`_FlashCoreRot` with rotary tables), the counterparts of the JAX package's two
`custom_vjp`s: the forward keeps the logsumexp, the backward computes
delta = rowsum(dO * O) in f32 and runs dQ and dK/dV. `_FlashCoreRot` rotates q
and k once in its forward (the bf16 pre-pass on CUDA) and saves the rotated
pair; its backward gives the tables to dQ and dK/dV, which return the
gradients of the unrotated q and k (the bf16 kernels and the f32 ones at
head dim 64 apply the rotary's transpose, `_rotary_transpose`'s arithmetic,
in their epilogue; after the f32 ones at other head dims `_unrotate` runs
in PyTorch). Otherwise
(`torch.no_grad()`, inference) it launches the forward without the
logsumexp.

The bf16 backward at head dim 64 (dQ also at 128) is the forward's design:
one warpgroup per 64 rows, the other axis streamed through a TMA ring, all
five products as wgmma, with K, Q and dO read MN-major from the same tiles
the scores read K-major (no transposed copies; `BwdWgCfg` in the source).

The f32 backward at head dim 64 (`flash_bwd_dq_f32_tile`,
`flash_bwd_dkv_f32_tile`; the VoMix and CoMix T2S recipes train in f32)
carries the f32 forward's SIMT register tiles over: one block per 64 rows,
8 rows x 4 columns of every product a thread, the streamed tiles
double-buffered by cp.async, true f32 FMAs (no TF32); it takes the rotary
tables as the bf16 kernels do. The other head dims keep one row per thread.

The kernels are built once per head dim (`-DFLASH_DH`), for the head dims
`kernel_supports_dh` admits: multiples of 16 up to 256. The dispatcher uses
the same rule, so a head dim outside it takes `layers.attend`.

`valid_len` is clamped to [1, T]. (The TPU kernel clamps only from below; a
valid_len above T there lets zero-padded keys in, which no caller does.)

`causal` (the T2S training decoder's self-attention) needs queries and keys of
one length, as in the JAX package: key j is live for query row i when
j < valid_len and j <= i. Rows past valid_len still see the keys below it."""

from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.ops.cuda_build import BUILD_DIR, build_library, csrc

SOURCE = csrc("flash_attention.cu")
MAX_DH = 256
F32_TILE_DH = 64   # the head dim of the tiled f32 kernels (the f32 backward takes rotary tables there)


def kernel_supports_dh(dh: int) -> bool:
    """The head dims the kernels are built for: multiples of 16 (the mma.sync
    k-step) up to 256 (the JAX dispatch rule's limit)."""
    return dh % 16 == 0 and 16 <= dh <= MAX_DH


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


class FlashKernel:
    """The kernel libraries (one per head dim) and their launch counts, each
    a plain integer that goes up by one exactly where its kernel is launched:
    `launches` (forward without logsumexp, the inference form),
    `lse_launches` (forward with logsumexp, the training form),
    `dq_launches` and `dkv_launches` (the backward kernels); the causal
    launches are counted apart, in `causal_launches`, `causal_lse_launches`,
    `causal_dq_launches` and `causal_dkv_launches`; `rotary_launches` counts
    the bf16 rotary pre-pass, which runs before a forward given tables.
    A launch made while the stream is being captured into a CUDA graph runs
    only when the graph is replayed: it counts in `captured` ({counter name:
    launches}) instead, which the graph's owner reads across its capture to
    know the launches of one replay (`train.loop.MultiStep`)."""

    def __init__(self):
        self.build_logs = {}
        self.captured = collections.Counter()
        self.rotary_launches = 0
        self.launches = 0
        self.lse_launches = 0
        self.dq_launches = 0
        self.dkv_launches = 0
        self.causal_launches = 0
        self.causal_lse_launches = 0
        self.causal_dq_launches = 0
        self.causal_dkv_launches = 0
        self._libs = {}
        self._locks = {}
        self._lock = threading.Lock()

    def _launched(self, counter: str) -> None:
        """One launch counted in `counter` (or, under capture, in `captured`)."""
        if torch.cuda.is_current_stream_capturing():
            self.captured[counter] += 1
        else:
            setattr(self, counter, getattr(self, counter) + 1)

    @staticmethod
    def lib_path(dh: int) -> str:
        return os.path.join(BUILD_DIR, f"libflash_attention_dh{dh}.so")

    def build(self, dh: int = 64) -> ctypes.CDLL:
        """Compile the source for head dim `dh` with nvcc (if its library is
        missing or older than the source) and load it. Builds of different
        head dims may run in parallel threads."""
        if not kernel_supports_dh(dh):
            raise NotImplementedError(f"flash kernel is built for head dims that are multiples of 16 "
                                      f"up to {MAX_DH}; got {dh}")
        with self._lock:
            lock = self._locks.setdefault(dh, threading.Lock())
        with lock:
            if dh in self._libs:
                return self._libs[dh]
            path = self.lib_path(dh)
            self.build_logs[dh] = build_library(SOURCE, path, [f"-DFLASH_DH={dh}"])
            lib = ctypes.CDLL(path)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.covomix_flash_attention_fwd.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp,
                                                        ci, ci, ci, ci, cf, vp]
            lib.covomix_flash_attention_bwd_dq.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp,
                                                           ci, ci, ci, ci, cf, vp]
            lib.covomix_flash_attention_bwd_dkv.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp,
                                                            vp, ci, ci, ci, ci, cf, vp]
            lib.covomix_flash_rotary_bf16.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
            for fn in (lib.covomix_flash_attention_fwd, lib.covomix_flash_attention_bwd_dq,
                       lib.covomix_flash_attention_bwd_dkv, lib.covomix_flash_rotary_bf16):
                fn.restype = ci
            lib.covomix_cuda_error_string.argtypes = [ci]
            lib.covomix_cuda_error_string.restype = ctypes.c_char_p
            self._libs[dh] = lib
            return lib

    @staticmethod
    def _check(q, k, v, valid, extra=()):
        """Validate q/k/v [B, H, T, dh] (and the other [B, H, T, dh] tensors in
        `extra`) and valid int32 [1] or [B]: one CUDA device, bf16 or f32,
        contiguous, 16-byte aligned."""
        tensors = [q, k, v, *extra]
        if not all(t.is_cuda and t.device == q.device for t in tensors + [valid]):
            raise ValueError("flash kernel: every tensor must be on the same CUDA device")
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
        if q.dim() != 4 or any(t.shape != q.shape or t.dtype != q.dtype for t in tensors):
            raise ValueError(f"flash kernel: q/k/v (and dO) must share one [B, H, T, dh] shape and dtype; "
                             f"got {[(tuple(t.shape), t.dtype) for t in tensors]}")
        if valid.dtype != torch.int32 or valid.dim() != 1 or valid.shape[0] not in (1, q.shape[0]):
            raise ValueError(f"flash kernel: valid_len must be int32 [1] or [B]; got {valid.dtype} "
                             f"{tuple(valid.shape)}")
        for x in tensors + [valid]:
            if not x.is_contiguous():
                raise ValueError("flash kernel: inputs must be contiguous")
        for x in tensors:
            if x.data_ptr() % 16:
                raise ValueError("flash kernel: q/k/v/dO must be 16-byte aligned")

    @staticmethod
    def _check_rows(q, rows):
        """lse / delta: contiguous f32 [B, H, T] on q's device."""
        for r in rows:
            if (r.dtype != torch.float32 or r.shape != q.shape[:3] or r.device != q.device
                    or not r.is_contiguous()):
                raise ValueError(f"flash kernel: lse / delta must be contiguous f32 {tuple(q.shape[:3])} on "
                                 f"{q.device}; got {r.dtype} {tuple(r.shape)} on {r.device}")

    def _raise_on(self, lib, err, what):
        if err != 0:
            raise RuntimeError(f"flash {what} launch failed: {lib.covomix_cuda_error_string(err).decode()}")

    @staticmethod
    def _check_tables(q, rotary):
        t, dh = q.shape[2:]
        for r in rotary:
            if (r.dtype != q.dtype or r.dim() != 2 or r.shape[0] < t or r.shape[1] != dh
                    or r.device != q.device or not r.is_contiguous() or r.data_ptr() % 16):
                raise ValueError(f"flash kernel: rotary tables must be contiguous, 16-byte aligned [>=T, dh] {q.dtype} on "
                                 f"{q.device}; got {r.dtype} {tuple(r.shape)}")

    def rotary(self, q, k, cos, sin):
        """The rotary pre-pass: (rot(q), rot(k)) for bf16 [B, H, T, dh] CUDA
        q, k and [>=T, dh] tables, `_rotary_plain`'s arithmetic bit for bit."""
        if not (q.is_cuda and k.device == q.device):
            raise ValueError("flash rotary pre-pass: q and k must be on the same CUDA device")
        if q.dtype != torch.bfloat16 or k.dtype != q.dtype or q.dim() != 4 or k.shape != q.shape:
            raise ValueError(f"flash rotary pre-pass takes bf16 q, k of one [B, H, T, dh] shape; got "
                             f"{q.dtype} {tuple(q.shape)}, {k.dtype} {tuple(k.shape)}")
        if not (q.is_contiguous() and k.is_contiguous()) or q.data_ptr() % 16 or k.data_ptr() % 16:
            raise ValueError("flash rotary pre-pass: q and k must be contiguous and 16-byte aligned")
        self._check_tables(q, (cos, sin))
        return self._rotate(q, k, cos, sin)

    def _rotate(self, q, k, cos, sin):
        """The pre-pass's launch, on inputs already checked."""
        b, h, t, dh = q.shape
        lib = self.build(dh)
        qr, kr = torch.empty_like(q), torch.empty_like(k)
        err = lib.covomix_flash_rotary_bf16(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                            qr.data_ptr(), kr.data_ptr(), b, h, t, dh, _stream(q))
        self._raise_on(lib, err, "rotary pre-pass")
        self._launched("rotary_launches")
        return qr, kr

    def __call__(self, q, k, v, valid, rotary=None, return_lse=False, causal=False):
        """Forward. q/k/v [B, H, T, dh] contiguous CUDA bf16 or f32; valid
        int32 [1] or [B] on the same device; rotary (cos, sin_signed)
        [>=T, dh] or None; `causal` masks key j > query i. Returns out, or
        (out, lse f32 [B, H, T]) with `return_lse`. bf16 with rotary runs
        the rotary pre-pass first; the f32 kernel rotates in place."""
        self._check(q, k, v, valid)
        b, h, t, dh = q.shape
        if rotary is not None:
            self._check_tables(q, rotary)
            if q.dtype == torch.bfloat16:
                q, k = self._rotate(q, k, *rotary)
                rotary = None
        lib = self.build(dh)
        out = torch.empty_like(q)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if return_lse else None
        err = lib.covomix_flash_attention_fwd(
            int(q.dtype == torch.float32), int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, valid.data_ptr(), valid.shape[0],
            rotary[0].data_ptr() if rotary is not None else None,
            rotary[1].data_ptr() if rotary is not None else None, b, h, t, dh, dh ** -0.5, _stream(q))
        self._raise_on(lib, err, "forward")
        if return_lse:
            if causal:
                self._launched("causal_lse_launches")
            else:
                self._launched("lse_launches")
            return out, lse
        if causal:
            self._launched("causal_launches")
        else:
            self._launched("launches")
        return out

    def _check_bwd(self, q, k, v, dout, lse, delta, valid, rotary):
        self._check(q, k, v, valid, (dout,))
        self._check_rows(q, (lse, delta))
        if rotary is None:
            return None, None
        if not backward_takes_tables(q):
            raise ValueError(f"flash backward: the f32 kernels take rotary tables at head dim {F32_TILE_DH} only")
        self._check_tables(q, rotary)
        return rotary[0].data_ptr(), rotary[1].data_ptr()

    def bwd_dq(self, q, k, v, dout, lse, delta, valid, causal=False, rotary=None):
        """dQ from the already rotated q, k, the output gradient dout, the
        forward's lse and delta = rowsum(dout * out) (f32 [B, H, T]). With
        `rotary` tables (cos, sin_signed) [>=T, dh] (bf16, or f32 at head dim
        64), dQ leaves through the rotary's transpose: the gradient of the
        unrotated q, `_rotary_transpose` of the dQ without tables, bit for
        bit."""
        cos, sin = self._check_bwd(q, k, v, dout, lse, delta, valid, rotary)
        b, h, t, dh = q.shape
        lib = self.build(dh)
        dq = torch.empty_like(q)
        err = lib.covomix_flash_attention_bwd_dq(
            int(q.dtype == torch.float32), int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), valid.data_ptr(), valid.shape[0], cos, sin,
            b, h, t, dh, dh ** -0.5, _stream(q))
        self._raise_on(lib, err, "dQ")
        if causal:
            self._launched("causal_dq_launches")
        else:
            self._launched("dq_launches")
        return dq

    def bwd_dkv(self, q, k, v, dout, lse, delta, valid, causal=False, rotary=None):
        """(dK, dV), with the same inputs as `bwd_dq`; with tables, dK leaves
        through the rotary's transpose."""
        cos, sin = self._check_bwd(q, k, v, dout, lse, delta, valid, rotary)
        b, h, t, dh = q.shape
        lib = self.build(dh)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.covomix_flash_attention_bwd_dkv(
            int(q.dtype == torch.float32), int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), valid.data_ptr(),
            valid.shape[0], cos, sin, b, h, t, dh, dh ** -0.5, _stream(q))
        self._raise_on(lib, err, "dK/dV")
        if causal:
            self._launched("causal_dkv_launches")
        else:
            self._launched("dkv_launches")
        return dk, dv


KERNEL = FlashKernel()


def backward_takes_tables(q) -> bool:
    """Whether the backward kernels take the rotary tables for q's dtype and
    head dim (and apply the rotary's transpose to dQ and dK themselves):
    every bf16 kernel, and the tiled f32 ones at head dim 64."""
    return q.dtype == torch.bfloat16 or q.shape[-1] == F32_TILE_DH


# ---------------------------------------------------------------------------
# rotary tables (halfsplit convention, acoustic model)


def rotary_tables_halfsplit(positions, inv_freq, dtype):
    """[T, dh] (cos, sin_signed) tables at `dtype`. sin_signed carries the
    rotate-half sign (first half negated), so rotary(x) = x*cos +
    roll(x, dh/2)*sin_signed."""
    freqs = positions[:, None].float() * inv_freq[None, :]
    freqs = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    d = sin.shape[-1] // 2
    sin_signed = torch.cat([-sin[:, :d], sin[:, d:]], dim=-1)
    return cos.to(dtype).contiguous(), sin_signed.to(dtype).contiguous()


def _roll_half(x):
    d = x.shape[-1] // 2
    return torch.cat([x[..., d:], x[..., :d]], dim=-1)


def _rotary_plain(x, cos, sin_signed):
    """x [..., T, dh] with [T, dh] tables, in f32 and rounded once to x.dtype
    (the kernel's arithmetic)."""
    xf = x.float()
    return (xf * cos.float() + _roll_half(xf) * sin_signed.float()).to(x.dtype)


def _rotary_transpose(g, cos, sin_signed):
    """The VJP of `_rotary_plain` in x: dx = g*cos + roll(g*sin_signed, dh/2)
    (the half roll is its own inverse), in f32 and rounded once to g.dtype;
    the port's copy of `_rotary_xla_transpose`."""
    gf = g.float()
    return (gf * cos.float() + _roll_half(gf * sin_signed.float())).to(g.dtype)


def _valid_array(valid_len, b: int, t: int, device) -> torch.Tensor:
    """valid_len (None / int / tensor of 1 or B entries) -> int32 [1] or [B]
    on `device`, clamped to [1, T]."""
    if valid_len is None:
        valid_len = t
    if isinstance(valid_len, int):      # a fill on the device, no host copy (capture-safe)
        v = torch.full((1,), valid_len, dtype=torch.int32, device=device)
    else:
        v = torch.as_tensor(valid_len, dtype=torch.int32, device=device).reshape(-1)
    if v.shape[0] not in (1, b):
        raise ValueError(f"valid_len must be scalar or [B]; got shape {tuple(v.shape)}")
    return torch.clamp(v, 1, t).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the comparison on the card)


def _live(valid, t, device, causal=False):
    """[1|B, 1, 1|T, T] bool: key j < valid_len of its row (and, with
    `causal`, j <= the query row i)."""
    j = torch.arange(t, device=device)
    live = (j[None, :] < valid.to(device).reshape(-1, 1))[:, None, None, :]
    if causal:
        live = live & (j[None, :] <= j[:, None])
    return live


def _scores(q, k, valid, causal=False):
    """s = q k^T dh^-0.5 in f32 with dead keys at -1e30."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * q.shape[-1] ** -0.5
    return torch.where(_live(valid, q.shape[2], q.device, causal), s, torch.full_like(s, -1e30))


def flash_attention_plain(q, k, v, valid, rotary=None, causal: bool = False, return_lse: bool = False):
    """The forward kernel's function in plain PyTorch, for CPU tensors (and
    as the comparison on the card). valid: int32 [1] or [B], already
    clamped. With `return_lse`, also lse = m + log(max(l, 1e-30)) f32
    [B, H, T]."""
    t = q.shape[2]
    if rotary is not None:
        cos, sin = rotary[0][:t], rotary[1][:t]
        q, k = _rotary_plain(q, cos, sin), _rotary_plain(k, cos, sin)
    s = _scores(q, k, valid, causal)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _probs_and_ds(q, k, v, dout, lse, delta, valid, causal):
    """p = exp(s - lse) (exactly 0 on dead pairs) and ds = p (dO v^T - delta),
    both f32 [B, H, T, T]."""
    p = torch.exp(_scores(q, k, valid, causal) - lse[..., None])
    dp = torch.einsum("bhid,bhjd->bhij", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_delta(dout, out):
    """delta = rowsum(dO * O) in f32 [B, H, T] (computed outside the kernels,
    as the JAX package computes it in XLA)."""
    return torch.sum(dout.float() * out.float(), dim=-1)


def _unrotate(x, rotary):
    """x through the rotary's transpose when tables are given (the gradient
    of the unrotated input), else x."""
    if rotary is None:
        return x
    t = x.shape[2]
    return _rotary_transpose(x, rotary[0][:t], rotary[1][:t])


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, valid, causal: bool = False, rotary=None):
    """The dQ kernel's function: dq = dh^-0.5 * bf16(ds) k, for q, k already
    rotated; with `rotary` tables, then `_rotary_transpose` of that."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, valid, causal)
    dq = torch.einsum("bhij,bhjd->bhid", ds.to(k.dtype).float(), k.float())
    return _unrotate((dq * q.shape[-1] ** -0.5).to(q.dtype), rotary)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, valid, causal: bool = False, rotary=None):
    """The dK/dV kernel's function: dv = bf16(p)^T dO, dk = dh^-0.5 *
    bf16(ds)^T q; with `rotary` tables, dk then through `_rotary_transpose`."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, valid, causal)
    dv = torch.einsum("bhij,bhid->bhjd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhij,bhid->bhjd", ds.to(q.dtype).float(), q.float())
    return _unrotate((dk * q.shape[-1] ** -0.5).to(k.dtype), rotary), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, g, valid, causal: bool = False):
    """(dq, dk, dv) of the forward at already rotated q, k, from its output
    `out`, its lse and the output gradient `g` (the formulas of the JAX
    package's `_flash_backward`, with its rounding points)."""
    delta = flash_delta(g, out)
    dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, valid, causal)
    return flash_bwd_dq_plain(q, k, v, g, lse, delta, valid, causal), dk, dv


# ---------------------------------------------------------------------------
# autograd


def _forward_lse(q, k, v, valid, rotary, causal):
    if q.is_cuda:
        return KERNEL(q, k, v, valid, rotary, return_lse=True, causal=causal)
    return flash_attention_plain(q, k, v, valid, rotary, causal, return_lse=True)


def _backward(q, k, v, out, lse, g, valid, causal, rotary=None):
    """(dq, dk, dv) at already rotated q, k (with `rotary` tables, dq and dk
    of the unrotated ones): the two backward kernels on CUDA tensors, the
    plain version on CPU tensors. The bf16 kernels and the f32 ones at head
    dim 64 apply the rotary's transpose themselves; after the f32 ones at
    the other head dims it runs in PyTorch."""
    g = g.contiguous()
    if not q.is_cuda:
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, g, valid, causal)
        return _unrotate(dq, rotary), _unrotate(dk, rotary), dv
    delta = flash_delta(g, out)
    tables = rotary if backward_takes_tables(q) else None
    dq = KERNEL.bwd_dq(q, k, v, g, lse, delta, valid, causal, tables)
    dk, dv = KERNEL.bwd_dkv(q, k, v, g, lse, delta, valid, causal, tables)
    if tables is None:
        dq, dk = _unrotate(dq, rotary), _unrotate(dk, rotary)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """Differentiable flash attention without rotary (`_flash_core`);
    `causal` is a constant."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal):
        out, lse = _forward_lse(q, k, v, valid, None, causal)
        ctx.save_for_backward(q, k, v, out, lse, valid)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, valid = ctx.saved_tensors
        return (*_backward(q, k, v, out, lse, g, valid, ctx.causal), None, None)


class _FlashCoreRot(torch.autograd.Function):
    """Differentiable flash attention with fused halfsplit rotary
    (`_flash_core_rot`); the tables and `causal` are constants. The forward
    rotates q and k once (bf16 on CUDA: the rotary pre-pass, `KERNEL.rotary`;
    otherwise `_rotary_plain`, the f32 kernel's and the plain version's
    arithmetic) and saves the rotated pair; the backward hands the tables to
    dQ and dK/dV, which return the gradients of the unrotated q and k."""

    @staticmethod
    def forward(ctx, q, k, v, valid, cos, sin, causal):
        if q.is_cuda and q.dtype == torch.bfloat16:
            q, k = KERNEL.rotary(q, k, cos, sin)
        else:
            q, k = _rotary_plain(q, cos, sin), _rotary_plain(k, cos, sin)
        out, lse = _forward_lse(q, k, v, valid, None, causal)
        ctx.save_for_backward(q, k, v, out, lse, valid, cos, sin)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, valid, cos, sin = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, valid, ctx.causal, (cos, sin))
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, valid_len=None, causal: bool = False, rotary=None):
    """q/k/v [B, H, T, dh] -> [B, H, T, dh]: softmax(q k^T dh^-0.5) v over the
    keys < valid_len (int, or one per row), and with `causal` over the keys
    j <= i (queries and keys of one length). `rotary`: optional (cos,
    sin_signed) [>=T, dh] halfsplit tables applied to q and k inside the
    kernel. CUDA tensors launch the kernels, CPU tensors run the plain
    versions. Differentiable in q, k, v: with grad enabled and an input that
    requires it, the forward keeps the logsumexp for the backward kernels;
    otherwise the forward without it runs."""
    if causal and q.shape[-2] != k.shape[-2]:
        raise ValueError(f"causal flash requires tq == tk (training self-attention); got "
                         f"{q.shape[-2]} and {k.shape[-2]}")
    b, h, t, dh = q.shape
    valid = _valid_array(valid_len, b, t, q.device)
    if rotary is not None:
        rotary = tuple(r[:t].to(q.dtype).contiguous() for r in rotary)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if rotary is not None:
            return _FlashCoreRot.apply(q, k, v, valid, *rotary, causal)
        return _FlashCore.apply(q, k, v, valid, causal)
    if q.is_cuda:
        return KERNEL(q, k, v, valid, rotary, causal=causal)
    return flash_attention_plain(q, k, v, valid, rotary, causal)


def use_flash_kernel(*, on_cuda: bool, tq: int, tk: int, dh: int, has_key_mask: bool,
                     causal: bool, min_seq_for_flash: int = 512) -> bool:
    """The dispatch rule of attend_flash_or_xla; the JAX rule's dh <= 256 is
    `kernel_supports_dh`."""
    return (not has_key_mask and on_cuda and tq >= min_seq_for_flash and kernel_supports_dh(dh)
            and (not causal or tq == tk))


def attend_flash_or_xla(q, k, v, *, key_mask=None, valid_len=None, causal: bool = False,
                        min_seq_for_flash: int = 512, rotary=None):
    """The JAX package's dispatch rule, with "on TPU" read as "on CUDA": the
    flash kernel when there is no key_mask, T >= min_seq_for_flash, the
    kernel is built for dh (a multiple of 16 up to 256) and (non-causal or
    tq == tk); `layers.attend` otherwise, with valid_len
    turned into a key mask. `rotary`: optional (positions [T], inv_freq
    [dh/2]) halfsplit rotary, fused into the kernel on the flash path."""
    t = q.shape[-2]
    use_flash = use_flash_kernel(on_cuda=q.is_cuda, tq=t, tk=k.shape[-2], dh=q.shape[-1],
                                 has_key_mask=key_mask is not None, causal=causal,
                                 min_seq_for_flash=min_seq_for_flash)
    if rotary is not None:
        positions, inv_freq = rotary
        if use_flash:
            tables = rotary_tables_halfsplit(positions, inv_freq, q.dtype)
            return flash_attention(q, k, v, valid_len=valid_len, causal=causal, rotary=tables)
        q = L.rotary_halfsplit(positions, inv_freq, q)
        k = L.rotary_halfsplit(positions, inv_freq, k)
    if use_flash:
        return flash_attention(q, k, v, valid_len=valid_len, causal=causal)
    if key_mask is None and valid_len is not None:
        vl = torch.as_tensor(valid_len, device=q.device).reshape(-1)
        key_mask = torch.arange(t, device=q.device)[None, :] < vl[:, None]
        key_mask = key_mask.expand(q.shape[0], t)
    return L.attend(q, k, v, key_mask=key_mask, causal=causal)
