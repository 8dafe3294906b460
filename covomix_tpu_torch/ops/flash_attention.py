"""Flash-attention forward (port of covomix_tpu/ops/flash_attention.py).

On a CUDA tensor, `flash_attention` launches the hand-written Hopper kernel
in `csrc/flash_attention.cu` (built with nvcc at first use into
`covomix_tpu_torch/_build/`, bound with ctypes). On a CPU tensor it runs
`flash_attention_plain`, the same arithmetic in plain PyTorch: keys past
`valid_len` set to -1e30 before the exp, `valid_len` clamped to >= 1, and the
output divided by max(l, 1e-30). There is no fallback from one to the other.

The kernel is built once per head dim (`-DFLASH_DH`), for the head dims
`kernel_supports_dh` admits: multiples of 16 up to 256. The dispatcher uses
the same rule, so a head dim outside it takes `layers.attend`.

`valid_len` is clamped to [1, T]. (The TPU kernel clamps only from below; a
valid_len above T there lets zero-padded keys in, which no caller does.)

Only the serving slice is ported: non-causal, no logsumexp output. Causal and
lse requests raise NotImplementedError (ROADMAP: flash training slice)."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from covomix_tpu_torch.models import layers as L

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "flash_attention.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
MAX_DH = 256
_TRAINING_SLICE = "ROADMAP.md 'TPU kernels to port': flash attention training slice (causal, lse, backward)"


def kernel_supports_dh(dh: int) -> bool:
    """The head dims the kernel is built for: multiples of 16 (the mma.sync
    k-step) up to 256 (the JAX dispatch rule's limit)."""
    return dh % 16 == 0 and 16 <= dh <= MAX_DH


class FlashKernel:
    """The kernel libraries (one per head dim) plus the launch count.
    `launches` goes up by one exactly where the kernel is launched."""

    def __init__(self):
        self.build_logs = {}
        self.launches = 0
        self._libs = {}
        self._locks = {}
        self._lock = threading.Lock()

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
            if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(SOURCE):
                nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                if not os.path.exists(nvcc):
                    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); cannot build "
                                       "the CUDA kernel")
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"   # concurrent builds never share a file
                cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                       "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DFLASH_DH={dh}", "-o", tmp, SOURCE]
                res = subprocess.run(cmd, capture_output=True, text=True)
                self.build_logs[dh] = res.stdout + res.stderr
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_logs[dh]}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.covomix_flash_attention_fwd.argtypes = [ci, vp, vp, vp, vp, vp, ci, vp, vp,
                                                        ci, ci, ci, ci, ctypes.c_float, vp]
            lib.covomix_flash_attention_fwd.restype = ci
            lib.covomix_cuda_error_string.argtypes = [ci]
            lib.covomix_cuda_error_string.restype = ctypes.c_char_p
            self._libs[dh] = lib
            return lib

    def __call__(self, q, k, v, valid, rotary=None):
        """q/k/v [B, H, T, dh] contiguous CUDA bf16 or f32; valid int32 [1] or
        [B] on the same device; rotary (cos, sin_signed) [>=T, dh] or None."""
        tensors = [q, k, v, valid] + (list(rotary) if rotary is not None else [])
        if not all(t.is_cuda and t.device == q.device for t in tensors):
            raise ValueError("flash kernel: every tensor must be on the same CUDA device")
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
        if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
            raise ValueError(f"flash kernel: q/k/v must share one [B, H, T, dh] shape; "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        b, h, t, dh = q.shape
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError("flash kernel: q, k and v must share one dtype")
        if valid.dtype != torch.int32 or valid.dim() != 1 or valid.shape[0] not in (1, b):
            raise ValueError(f"flash kernel: valid_len must be int32 [1] or [B]; got {valid.dtype} "
                             f"{tuple(valid.shape)}")
        if rotary is not None:
            for r in rotary:
                if r.dtype != q.dtype or r.dim() != 2 or r.shape[0] < t or r.shape[1] != dh:
                    raise ValueError(f"flash kernel: rotary tables must be [>=T, dh] {q.dtype}; "
                                     f"got {r.dtype} {tuple(r.shape)}")
        for x in tensors:
            if not x.is_contiguous():
                raise ValueError("flash kernel: inputs must be contiguous")
        for x in (q, k, v):
            if x.data_ptr() % 16:
                raise ValueError("flash kernel: q/k/v must be 16-byte aligned")
        lib = self.build(dh)
        out = torch.empty_like(q)
        cos_p = rotary[0].data_ptr() if rotary is not None else None
        sin_p = rotary[1].data_ptr() if rotary is not None else None
        err = lib.covomix_flash_attention_fwd(
            int(q.dtype == torch.float32), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            valid.data_ptr(), valid.shape[0], cos_p, sin_p, b, h, t, dh, dh ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash kernel launch failed: {lib.covomix_cuda_error_string(err).decode()}")
        self.launches += 1
        return out


KERNEL = FlashKernel()


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


def _rotary_plain(x, cos, sin_signed):
    """x [..., T, dh] with [T, dh] tables, in f32 and rounded once to x.dtype
    (the kernel's arithmetic)."""
    d = x.shape[-1] // 2
    xf = x.float()
    rolled = torch.cat([xf[..., d:], xf[..., :d]], dim=-1)
    return (xf * cos.float() + rolled * sin_signed.float()).to(x.dtype)


def _valid_array(valid_len, b: int, t: int, device) -> torch.Tensor:
    """valid_len (None / int / tensor of 1 or B entries) -> int32 [1] or [B]
    on `device`, clamped to [1, T]."""
    if valid_len is None:
        valid_len = t
    v = torch.as_tensor(valid_len, dtype=torch.int32, device=device).reshape(-1)
    if v.shape[0] not in (1, b):
        raise ValueError(f"valid_len must be scalar or [B]; got shape {tuple(v.shape)}")
    return torch.clamp(v, 1, t).to(torch.int32).contiguous()


def flash_attention_plain(q, k, v, valid, rotary=None):
    """The kernel's function in plain PyTorch, for CPU tensors (and as the
    comparison on the card). valid: int32 [1] or [B], already clamped."""
    b, h, t, dh = q.shape
    if rotary is not None:
        cos, sin = rotary[0][:t], rotary[1][:t]
        q, k = _rotary_plain(q, cos, sin), _rotary_plain(k, cos, sin)
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * dh ** -0.5
    live = torch.arange(t, device=q.device)[None, :] < valid.to(q.device).reshape(-1, 1)   # [1|B, T]
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention(q, k, v, *, valid_len=None, causal: bool = False, rotary=None,
                    return_lse: bool = False):
    """q/k/v [B, H, T, dh] -> [B, H, T, dh]: softmax(q k^T dh^-0.5) v over the
    keys < valid_len (int, or one per row). `rotary`: optional (cos,
    sin_signed) [>=T, dh] halfsplit tables applied to q and k inside the
    kernel. CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if causal or return_lse:
        raise NotImplementedError(f"causal / lse flash attention is not ported yet ({_TRAINING_SLICE})")
    b, h, t, dh = q.shape
    valid = _valid_array(valid_len, b, t, q.device)
    if rotary is not None:
        rotary = tuple(r[:t].to(q.dtype).contiguous() for r in rotary)
    if q.is_cuda:
        return KERNEL(q.contiguous(), k.contiguous(), v.contiguous(), valid, rotary)
    return flash_attention_plain(q, k, v, valid, rotary)


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
