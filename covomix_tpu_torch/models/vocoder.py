"""HiFi-GAN generator: port of covomix_tpu/models/vocoder.py (generator only).

conv_pre 80->C k7 -> per stage [leaky_relu(0.1) -> ConvTranspose1d upsample ->
mean of the |K| MRF ResBlocks] -> leaky_relu(0.01) -> conv_post -> tanh.

With `valid_len` (mel frames, scalar or per row) activations past each row's
valid extent are zeroed after every conv, and the extent follows the
ConvTranspose1d length chain, so the first output_length(n) samples of a row
equal an exact-length run. The JAX package's packed MRF (`_mrf_packed`) is a
TPU lane-layout trick with the same math as the three-branch sum / 3 used here.
The fused tail kernels are not ported yet (`fuse_tail=True` raises)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.acoustic import conv1d_init

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    num_mels: int = 80
    upsample_initial_channel: int = 500
    upsample_rates: tuple = (5, 4, 4, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    resblock: str = "1"
    sampling_rate: int = 8000

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out


def get_padding(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def output_length(cfg: VocoderConfig, frames: int) -> int:
    """Samples for `frames` mel frames: the ConvTranspose1d length chain
    ((T-1)*u - 2p + k per stage). covomix config: 160*T + 32."""
    t = frames
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        t = (t - 1) * u - 2 * ((k - u) // 2) + k
    return t


def init_generator(gen: torch.Generator, cfg: VocoderConfig, device=None):
    """Random generator parameters drawn from `gen` (JAX package names/shapes)."""
    device = device or gen.device
    c0 = cfg.upsample_initial_channel
    p = {"conv_pre": conv1d_init(gen, cfg.num_mels, c0, 7, device=device)}
    ups, resblocks = [], []
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = c0 // (2 ** i), c0 // (2 ** (i + 1))
        ups.append(conv1d_init(gen, cin, cout, k, device=device))  # [K, Cin, Cout]
        for kr, dr in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "1":
                resblocks.append({
                    "convs1": [conv1d_init(gen, cout, cout, kr, device=device) for _ in dr],
                    "convs2": [conv1d_init(gen, cout, cout, kr, device=device) for _ in dr]})
            else:
                resblocks.append({"convs": [conv1d_init(gen, cout, cout, kr, device=device) for _ in dr]})
    p["ups"] = ups
    p["resblocks"] = resblocks
    p["conv_post"] = conv1d_init(gen, c0 // (2 ** len(cfg.upsample_rates)), 1, 7, device=device)
    return p


def _resblock1(p, x, kernel: int, dilations: Sequence[int], mask_fn=None):
    m = mask_fn or (lambda h: h)
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        xt = L.leaky_relu(x, LRELU_SLOPE)
        xt = m(L.conv1d(c1, xt, padding=get_padding(kernel, d), rhs_dilation=d))
        xt = L.leaky_relu(xt, LRELU_SLOPE)
        xt = m(L.conv1d(c2, xt, padding=get_padding(kernel, 1)))
        x = xt + x
    return x


def _resblock2(p, x, kernel: int, dilations: Sequence[int], mask_fn=None):
    m = mask_fn or (lambda h: h)
    for c, d in zip(p["convs"], dilations):
        xt = L.leaky_relu(x, LRELU_SLOPE)
        xt = m(L.conv1d(c, xt, padding=get_padding(kernel, d), rhs_dilation=d))
        x = xt + x
    return x


def _length_mask(vl):
    def mask(h):
        keep = torch.arange(h.shape[1], device=h.device)[None, :] < vl[:, None]
        return h * keep[..., None].to(h.dtype)
    return mask


@torch.no_grad()
def generator(params, cfg: VocoderConfig, mel, dtype=torch.float32, fuse_tail: bool = False,
              valid_len=None):
    """mel [B, T, num_mels] -> waveform [B, output_length(T)] in [-1, 1], f32."""
    if fuse_tail:
        raise NotImplementedError("the fused vocoder-tail kernels are not ported yet "
                                  "(ROADMAP: vocoder-tail kernels)")
    mask_fn = None
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, dtype=torch.int32, device=mel.device).reshape(-1)
        mask_fn = _length_mask(vl)
        mel = mask_fn(mel)  # pad frames must read as zero
    x = L.conv1d(params["conv_pre"], mel.to(dtype), padding=3)
    if mask_fn is not None:
        x = mask_fn(x)
    n_kernels = len(cfg.resblock_kernel_sizes)
    rb = _resblock1 if cfg.resblock == "1" else _resblock2
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        stage_blocks = params["resblocks"][i * n_kernels:(i + 1) * n_kernels]
        x = L.leaky_relu(x, LRELU_SLOPE)
        x = L.conv_transpose1d(params["ups"][i], x, stride=u, padding=(k - u) // 2, kernel=k)
        if mask_fn is not None:
            vl = (vl - 1) * u - 2 * ((k - u) // 2) + k
            mask_fn = _length_mask(vl)
            x = mask_fn(x)
        acc = None
        for j in range(n_kernels):
            y = rb(stage_blocks[j], x, cfg.resblock_kernel_sizes[j], cfg.resblock_dilation_sizes[j],
                   mask_fn=mask_fn)
            acc = y if acc is None else acc + y
        x = acc / n_kernels
    x = L.leaky_relu(x)  # default slope 0.01
    x = L.conv1d(params["conv_post"], x, padding=3)
    return torch.tanh(x)[..., 0].float()
