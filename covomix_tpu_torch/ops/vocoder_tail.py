"""Fused HiFi-GAN upsample stage and tail (port of covomix_tpu/ops/vocoder_tail.py).

`fused_stage`: lrelu(0.1) -> ConvTranspose1d(rate 4, kernel 4, padding 0) ->
3-branch ResBlock1 MRF / 3, x1 [B, T1, Cin] -> [B, 4*T1, C] in x1's dtype.
`fused_tail`: lrelu(0.1) -> ConvTranspose1d(rate 2, kernel 4, padding 1) ->
MRF / 3 -> lrelu(0.01) -> conv_post(kernel 7) -> tanh, x2 [B, T2, Cin] ->
wav [B, 2*T2] f32.

On a CUDA tensor each launches the hand-written Hopper kernel in
`csrc/vocoder_tail.cu` (one library for both dtypes, built with nvcc at first
use into `covomix_tpu_torch/_build/`, bound with ctypes); on a CPU tensor it
runs the plain PyTorch version beside it. There is no fallback from one to
the other. Both round where the TPU kernel rounds: the activated input, the
upsample output, each conv1 output and each residual state to the activation
dtype; conv sums, the branch sum and the /3 in f32; the post-lrelu output to
the activation dtype before conv_post. Weights are rounded to the activation
dtype, biases stay f32.

The parameters are the generator's own (`ups[i]`, the stage's three
ResBlock1 dicts, `conv_post`); the wrapper packs them for the kernel once per
parameter set (channels padded to 32 or 64, MRF weights tap-major, so that
each tap is one 16-byte aligned slice the kernel's weight ring copies whole:
in tensor-core fragment order for bf16, and for f32 [ci][h][g][4] with
co = 8 g + 4 h + e, so that the 8-channel groups of a warp read one
contiguous run). Per launch it asks the
library for the block plan (`covomix_vocoder_plan`: the tile, chosen in the
C code from the card's SM count so that the last wave of blocks is not
mostly empty) and allocates the f32 scratch that holds each block's branch
sum."""

from __future__ import annotations

import ctypes
import os
import threading
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.ops.cuda_build import BUILD_DIR, build_library, csrc
from covomix_tpu_torch.util.misc import tree_leaves

SOURCE = csrc("vocoder_tail.cu")
LRELU = 0.1
POST_LRELU = 0.01
POST_KERNEL = 7
MAX_CHANNELS = 64


class VocoderTailLibrary:
    """The compiled kernel library (both dtypes, both kinds)."""

    def __init__(self):
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @staticmethod
    def lib_path() -> str:
        return os.path.join(BUILD_DIR, "libvocoder_tail.so")

    def build(self) -> ctypes.CDLL:
        """Compile the source with nvcc (if the library is missing or older
        than the source) and load it."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.lib_path()
            self.build_log = build_library(SOURCE, path)
            lib = ctypes.CDLL(path)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.covomix_vocoder_fused.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, ctypes.c_float, vp,
                                                  ci, ci, ci, ci, ci, vp, vp]
            lib.covomix_vocoder_fused.restype = ci
            lib.covomix_vocoder_plan.argtypes = [ci, ci, ci, vp, ci, ci, ci, ci, vp, vp]
            lib.covomix_vocoder_plan.restype = ci
            lib.covomix_vocoder_error_string.argtypes = [ci]
            lib.covomix_vocoder_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib


LIBRARY = VocoderTailLibrary()


class Plan(NamedTuple):
    """A launch's block plan, as covomix_vocoder_plan chose it."""
    tile: int        # output rows per block
    halo: int        # rows a block reads beyond each side of its tile
    smem: int        # shared memory bytes per block (one block per SM)
    blocks: int
    waves: float     # blocks / SMs
    scratch: int     # f32 elements of the blocks' branch sums
    # per MRF conv: (rows, units, busiest warp's units, idlest warp's units); a
    # bf16 unit is a 16-row x 32-channel m-tile, an f32 unit one row x 8 channels
    convs: tuple


class Packed(NamedTuple):
    """Kernel-layout weights of one stage (or tail) at one dtype and device."""
    cp: int                 # channel padding, 32 or 64
    cin: int
    c: int
    w_up: torch.Tensor      # [4, cin, cp] dtype
    b_up: torch.Tensor      # [cp] f32
    w_mrf: torch.Tensor     # 18 convs of k * cp * cp, flat, dtype (tap-major; see pack_weights)
    b_mrf: torch.Tensor     # [18, cp] f32
    w_post: torch.Tensor    # [7, cp] dtype (tail; zeros for the stage)
    b_post: float
    taps: tuple             # 3 kernel sizes, then 3x3 dilations by branch


def _check_taps(kernels, dilations):
    if len(kernels) != 3 or len(dilations) != 3 or any(len(d) != 3 for d in dilations):
        raise ValueError(f"the fused vocoder kernels take 3 ResBlock1 branches of 3 levels; got "
                         f"kernels {kernels}, dilations {dilations}")


def _mma_fragment_order(w):
    """[k, cp, cp] (ci, co) -> flat, in the order conv_mma reads its B
    fragments: per (tap, 16-channel k-step, 8-channel n-tile), 32 lanes
    (g = co % 8, t) of [ci 2t, 2t+1, 2t+8, 2t+9]."""
    k, cp, _ = w.shape
    w = w.reshape(k, cp // 16, 2, 4, 2, cp // 8, 8)       # tau, ks, half, t, pair, nt, g
    return w.permute(0, 1, 5, 6, 3, 2, 4).reshape(-1)      # tau, ks, nt, g, t, half, pair


def _f32_tap_order(w):
    """[k, cp, cp] (ci, co) -> flat, in the order conv_f32 reads a tap: per
    (tap, ci), the first 4 channels of each 8-channel group g, then their
    last 4 ([ci][h][g][4], co = 8 g + 4 h + e)."""
    k, cp, _ = w.shape
    return w.reshape(k, cp, cp // 8, 2, 4).permute(0, 1, 3, 2, 4).reshape(-1)


def pack_weights(up_p, resblocks, post_p, kernels, dilations, dtype, device) -> Packed:
    """The kernel's layout of one stage's parameters (post_p None for the stage)."""
    _check_taps(kernels, dilations)
    k_up, cin, c = up_p["w"].shape
    if k_up != 4 or c > MAX_CHANNELS:
        raise ValueError(f"fused vocoder kernels take a kernel-4 upsample to at most {MAX_CHANNELS} "
                         f"channels; got weights {tuple(up_p['w'].shape)}")
    cp = 32 if c <= 32 else 64

    def pad(w, *widths):
        return F.pad(w.float(), widths)

    w_up = pad(up_p["w"], 0, cp - c).to(dtype)
    mrf_w, mrf_b = [], []
    for j, k in enumerate(kernels):
        for l in range(3):
            for which in ("convs1", "convs2"):
                p = resblocks[j][which][l]
                w = pad(p["w"], 0, cp - c, 0, cp - c).to(dtype)          # [k, cp, cp]
                mrf_w.append(_mma_fragment_order(w) if dtype == torch.bfloat16 else _f32_tap_order(w))
                mrf_b.append(pad(p["b"], 0, cp - c))
    if post_p is not None:
        w_post = pad(post_p["w"][:, :, 0], 0, cp - c).to(dtype)
        b_post = float(post_p["b"].reshape(-1)[0])
    else:
        w_post = torch.zeros((POST_KERNEL, cp), dtype=dtype, device=up_p["w"].device)
        b_post = 0.0
    taps = tuple(int(k) for k in kernels) + tuple(int(d) for ds in dilations for d in ds)
    on = lambda t: t.to(device).contiguous()
    return Packed(cp, cin, c, on(w_up), on(pad(up_p["b"], 0, cp - c)), on(torch.cat(mrf_w)),
                  on(torch.stack(mrf_b)), on(w_post), b_post, taps)


# packed weights per parameter set: id(upsample weight) -> (a weak reference
# to that tensor, {(dtype, device, ...): Packed}); the entry goes with the tensor
_PACKED = {}


def _packed(up_p, resblocks, post_p, kernels, dilations, dtype, device) -> Packed:
    w = up_p["w"]
    entry = _PACKED.get(id(w))
    if entry is None or entry[0]() is not w:
        entry = _PACKED[id(w)] = (weakref.ref(w), {})
        weakref.finalize(w, _PACKED.pop, id(w), None)
    key = (dtype, str(device), post_p is not None, tuple(kernels), tuple(map(tuple, dilations)))
    if key not in entry[1]:
        entry[1][key] = pack_weights(up_p, resblocks, post_p, kernels, dilations, dtype, device)
    return entry[1][key]


class FusedKernel:
    """One of the two kernels (stage or tail) plus its launch count.
    `launches` goes up by one exactly where the kernel is launched."""

    def __init__(self, tail: bool):
        self.tail = tail
        self.launches = 0

    def plan(self, x, packed: Packed) -> Plan:
        """The block plan the kernel is launched with on x (CUDA)."""
        b, t, _ = x.shape
        lib = LIBRARY.build()
        plan, convs = (ctypes.c_longlong * 6)(), (ctypes.c_int * 72)()
        err = lib.covomix_vocoder_plan(int(self.tail), int(x.dtype == torch.float32), packed.cp,
                                       (ctypes.c_int * 12)(*packed.taps), b, t, packed.cin,
                                       x.device.index if x.device.index is not None else torch.cuda.current_device(),
                                       plan, convs)
        if err != 0:
            raise RuntimeError(f"fused {'tail' if self.tail else 'stage'} plan failed: "
                               f"{lib.covomix_vocoder_error_string(err).decode()}")
        tile, halo, smem, blocks, sms, scratch = plan
        rows = tuple(tuple(convs[4 * i:4 * i + 4]) for i in range(18))
        return Plan(tile, halo, smem, blocks, blocks / sms, scratch, rows)

    def __call__(self, x, packed: Packed):
        """x [B, T, cin] contiguous CUDA bf16 or f32, 16-byte aligned;
        packed: its weights."""
        name = "fused tail" if self.tail else "fused stage"
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} kernel takes bf16 or f32, got {x.dtype}")
        if x.dim() != 3 or x.shape[2] != packed.cin or x.shape[1] < 1:
            raise ValueError(f"{name} kernel: x must be [B, T, {packed.cin}]; got {tuple(x.shape)}")
        for t in (x, packed.w_up, packed.b_up, packed.w_mrf, packed.b_mrf, packed.w_post):
            if not (t.is_cuda and t.device == x.device):
                raise ValueError(f"{name} kernel: input and weights must be on one CUDA device")
            if not t.is_contiguous():
                raise ValueError(f"{name} kernel: tensors must be contiguous")
        if packed.w_up.dtype != x.dtype or packed.w_mrf.dtype != x.dtype:
            raise ValueError(f"{name} kernel: weights packed as {packed.w_up.dtype}, input is {x.dtype}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} kernel: x must start 16-byte aligned (the kernel reads it in 16-byte chunks)")
        b, t, _ = x.shape
        grid = self.plan(x, packed)
        scratch = torch.empty(grid.scratch, dtype=torch.float32, device=x.device)
        if self.tail:
            out = torch.empty((b, 2 * t), dtype=torch.float32, device=x.device)
        else:
            out = torch.empty((b, 4 * t, packed.c), dtype=x.dtype, device=x.device)
        lib = LIBRARY.build()
        err = lib.covomix_vocoder_fused(
            int(self.tail), int(x.dtype == torch.float32), packed.cp, x.data_ptr(), out.data_ptr(),
            packed.w_up.data_ptr(), packed.b_up.data_ptr(), packed.w_mrf.data_ptr(), packed.b_mrf.data_ptr(),
            packed.w_post.data_ptr(), packed.b_post, (ctypes.c_int * 12)(*packed.taps), b, t, packed.cin,
            packed.c, grid.tile, scratch.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: {lib.covomix_vocoder_error_string(err).decode()}")
        self.launches += 1
        return out


STAGE = FusedKernel(tail=False)
TAIL = FusedKernel(tail=True)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the comparison on the card)


def _act(x, slope, dtype):
    return L.leaky_relu(x.float(), slope).to(dtype)


def _conv_f32(h, p, d: int, dtype):
    """Zero-padded conv with taps at offsets d*(tau - k//2): operands rounded
    to `dtype`, products summed in f32, plus the f32 bias. h [B, T, Cin]."""
    w = p["w"].to(dtype).float()                    # [k, Cin, Cout]
    k = w.shape[0]
    lo = d * (k // 2)
    xt = F.pad(h.float().transpose(1, 2), (lo, d * (k - 1) - lo))
    return F.conv1d(xt, w.permute(2, 1, 0), dilation=d).transpose(1, 2) + p["b"].float()


def _mrf_plain(up, resblocks, kernels, dilations):
    """Branch sum / 3 in f32 of the three ResBlock1 branches over `up`."""
    dt = up.dtype
    bsum = None
    for j in range(len(kernels)):
        state = up
        for l, d in enumerate(dilations[j]):
            h = _conv_f32(_act(state, LRELU, dt), resblocks[j]["convs1"][l], d, dt).to(dt)
            h = _conv_f32(_act(h, LRELU, dt), resblocks[j]["convs2"][l], 1, dt)
            state = (h + state.float()).to(dt)
        bsum = state.float() if bsum is None else bsum + state.float()
    return bsum / 3.0


def fused_stage_plain(x1, up_p, resblocks, kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    _check_taps(kernels, dilations)
    dt = x1.dtype
    b, t, _ = x1.shape
    w = up_p["w"].to(dt).float()                    # [4, Cin, C]: y[4t + j] = w[j] x[t]
    up = torch.einsum("btc,jcd->btjd", _act(x1, LRELU, dt).float(), w).reshape(b, 4 * t, w.shape[2])
    up = (up + up_p["b"].float()).to(dt)
    return _mrf_plain(up, resblocks, kernels, dilations).to(dt)


def fused_tail_plain(x2, up_p, resblocks, post_p, kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    _check_taps(kernels, dilations)
    dt = x2.dtype
    w = up_p["w"].to(dt).float().permute(1, 2, 0)   # [Cin, C, 4]
    up = F.conv_transpose1d(_act(x2, LRELU, dt).float().transpose(1, 2), w, stride=2, padding=1)
    up = (up.transpose(1, 2) + up_p["b"].float()).to(dt)
    m = _act(_mrf_plain(up, resblocks, kernels, dilations), POST_LRELU, dt)
    return torch.tanh(_conv_f32(m, post_p, 1, dt))[..., 0]


def _aligned(x):
    """x contiguous and starting 16-byte aligned (a copy if it is not)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _refuse_grad(name, *inputs):
    """Raise if grad mode is on and the input or a weight requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(inputs)):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() (training runs the "
                           f"generator with fuse_tail=False)")


def fused_stage(x1, up_p, resblocks, kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    """x1 [B, T1, Cin] (pre-activation input of the rate-4 stage) -> the MRF
    output [B, 4*T1, C] in x1's dtype. CUDA tensors launch the kernel, CPU
    tensors run the plain version. Raises where autograd would record the
    call: the kernel has no backward (the JAX package's has no VJP)."""
    _refuse_grad("fused_stage", x1, up_p, resblocks)
    if x1.is_cuda:
        return STAGE(_aligned(x1), _packed(up_p, resblocks, None, kernels, dilations, x1.dtype, x1.device))
    return fused_stage_plain(x1, up_p, resblocks, kernels, dilations)


def fused_tail(x2, up_p, resblocks, post_p, kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    """x2 [B, T2, Cin] (pre-activation input of the last stage) -> wav
    [B, 2*T2] f32. CUDA tensors launch the kernel, CPU tensors run the plain
    version. Raises where autograd would record the call, as fused_stage."""
    _refuse_grad("fused_tail", x2, up_p, resblocks, post_p)
    if x2.is_cuda:
        return TAIL(_aligned(x2), _packed(up_p, resblocks, post_p, kernels, dilations, x2.dtype, x2.device))
    return fused_tail_plain(x2, up_p, resblocks, post_p, kernels, dilations)
