"""HiFi-GAN generator: port of covomix_tpu/models/vocoder.py (generator only).

conv_pre 80->C k7 -> per stage [leaky_relu(0.1) -> ConvTranspose1d upsample ->
mean of the |K| MRF ResBlocks] -> leaky_relu(0.01) -> conv_post -> tanh.

With `valid_len` (mel frames, scalar or per row) activations past each row's
valid extent are zeroed after every conv, and the extent follows the
ConvTranspose1d length chain, so the first output_length(n) samples of a row
equal an exact-length run. The JAX package's packed MRF (`_mrf_packed`) is a
TPU lane-layout trick with the same math as the three-branch sum / 3 used here.

`fuse_tail` runs the rate-4 stage before the last and the last stage (with
conv_post and tanh) through the fused kernels of `ops/vocoder_tail.py`, by
the JAX package's rule: None means "on CUDA and a covomix-shaped config", and
`valid_len` forces the unfused path (the fused kernels are static-length)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.acoustic import conv1d_init
from covomix_tpu_torch.ops import vocoder_tail as VT

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


def config_from_json(h: dict) -> VocoderConfig:
    """A HiFi-GAN `vocoder_config.json` (or an `.npz` sidecar's "config") ->
    VocoderConfig, with the covomix defaults for missing keys (the JAX CLIs'
    mapping; keys of the mel analysis are not read here)."""
    return VocoderConfig(
        num_mels=int(h.get("num_mels", 80)),
        upsample_initial_channel=int(h.get("upsample_initial_channel", 500)),
        upsample_rates=tuple(h.get("upsample_rates", [5, 4, 4, 2])),
        upsample_kernel_sizes=tuple(h.get("upsample_kernel_sizes", [8, 8, 4, 4])),
        resblock_kernel_sizes=tuple(h.get("resblock_kernel_sizes", [3, 7, 11])),
        resblock_dilation_sizes=tuple(tuple(d) for d in h.get("resblock_dilation_sizes", [[1, 3, 5]] * 3)),
        resblock=str(h.get("resblock", "1")),
        sampling_rate=int(h.get("sampling_rate", 8000)),
    )


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


def _can_fuse_tail(cfg: VocoderConfig) -> bool:
    """The fused tail covers [lrelu -> ConvTranspose1d(r=2, k=4, p=1) ->
    3-branch ResBlock1 MRF -> lrelu(0.01) -> conv_post(k=7) -> tanh]: the
    covomix config's tail (the JAX package's rule)."""
    return (cfg.resblock == "1" and len(cfg.resblock_kernel_sizes) == 3
            and cfg.upsample_rates[-1] == 2 and cfg.upsample_kernel_sizes[-1] == 4
            and 4 * (cfg.upsample_initial_channel // (2 ** len(cfg.upsample_rates))) <= 128)


def _length_mask(vl):
    def mask(h):
        keep = torch.arange(h.shape[1], device=h.device)[None, :] < vl[:, None]
        return h * keep[..., None].to(h.dtype)
    return mask


@torch.no_grad()
def generator(params, cfg: VocoderConfig, mel, dtype=torch.float32, fuse_tail: bool = None,
              valid_len=None):
    """mel [B, T, num_mels] -> waveform [B, output_length(T)] in [-1, 1], f32.

    fuse_tail: None = auto (CUDA tensor and `_can_fuse_tail`); True runs the
    fused stage / tail wherever the per-stage rule admits them (their plain
    versions on CPU tensors). valid_len (scalar or [B], in mel frames) forces
    the unfused path."""
    mask_fn = None
    if valid_len is not None:
        fuse_tail = False
        vl = torch.as_tensor(valid_len, dtype=torch.int32, device=mel.device).reshape(-1)
        mask_fn = _length_mask(vl)
        mel = mask_fn(mel)  # pad frames must read as zero
    x = L.conv1d(params["conv_pre"], mel.to(dtype), padding=3)
    if mask_fn is not None:
        x = mask_fn(x)
    n_kernels = len(cfg.resblock_kernel_sizes)
    rb = _resblock1 if cfg.resblock == "1" else _resblock2
    n_stages = len(cfg.upsample_rates)
    if fuse_tail is None:
        fuse_tail = mel.is_cuda and _can_fuse_tail(cfg)
    taps = (cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        channels = cfg.upsample_initial_channel // (2 ** (i + 1))
        stage_blocks = params["resblocks"][i * n_kernels:(i + 1) * n_kernels]
        if fuse_tail and i == n_stages - 2 and u == 4 and k == 4 and 4 * channels <= 256:
            x = VT.fused_stage(x, params["ups"][i], stage_blocks, *taps)
            continue
        if fuse_tail and i == n_stages - 1 and x.shape[1] % 2 == 0:
            return VT.fused_tail(x, params["ups"][i], stage_blocks, params["conv_post"], *taps)
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
