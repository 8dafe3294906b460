"""HiFi-GAN: port of covomix_tpu/models/vocoder.py (generator, MPD / MSD
discriminators, GAN losses).

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
`valid_len` forces the unfused path (the fused kernels are static-length).
The generator is differentiable on the unfused path (training); the fused
kernels have no backward, and inference callers run it under no_grad.

The discriminators keep the JAX layouts: MPD weights [kh, kw, I, O] over the
input reshaped to [B, T/p, p, 1], MSD weights [K, I/g, O]; their feature maps
come back in those layouts ([B, H, W, C] / [B, T, C], views of the NCHW /
NCT tensors the convolutions run on)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.layers import conv1d_init
from covomix_tpu_torch.ops import vocoder_tail as VT
from covomix_tpu_torch.util import profiling

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


@profiling.scoped("vocoder.generator")
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


# ---------------------------------------------------------------------------
# discriminators (hifi-gan/models.py:128-248)

_MPD_PERIODS = (2, 3, 5, 7, 11)
_MPD_CHANNELS = (32, 128, 512, 1024, 1024)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device) * 0.02


def init_mpd(gen: torch.Generator, device=None):
    """Five DiscriminatorP: Conv2d (5, 1) stride (3, 1) (the last stride 1)
    to 32-1024 channels and a (3, 1) conv_post; weights [kh, kw, I, O]
    N(0, 0.02^2), zero biases, drawn from `gen`."""
    device = device or gen.device
    ds = []
    for _ in _MPD_PERIODS:
        convs, cin = [], 1
        for cout in _MPD_CHANNELS:
            convs.append({"w": _normal(gen, (5, 1, cin, cout), device), "b": torch.zeros(cout, device=device)})
            cin = cout
        ds.append({"convs": convs, "conv_post": {"w": _normal(gen, (3, 1, 1024, 1), device),
                                                 "b": torch.zeros(1, device=device)}})
    return {"discriminators": ds}


def _conv2d_nchw(p, x, stride, padding):
    """x [B, C, H, W] with HWIO weights [kh, kw, I, O]; symmetric padding (ph, pw)."""
    return F.conv2d(x, p["w"].to(x.dtype).permute(3, 2, 0, 1), p["b"].to(x.dtype), stride=stride,
                    padding=padding)


def _conv2d(p, x, stride, padding):
    """The JAX package's NHWC form: x [B, H, W, C], HWIO weights,
    padding [(lo, hi), (lo, hi)] with lo == hi."""
    pad = tuple(lo for lo, _ in padding)
    return _conv2d_nchw(p, x.permute(0, 3, 1, 2), stride, pad).permute(0, 2, 3, 1)


def _disc_p(p, x, period: int):
    """x [B, T] -> (score [B, n], fmaps [B, H, W, C]). DiscriminatorP
    (hifi-gan/models.py:128-161): reflect-pad T to a multiple of the period."""
    b, t = x.shape
    n_pad = (-t) % period
    if n_pad:
        x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
        t = t + n_pad
    x = x.reshape(b, 1, t // period, period)
    fmap = []
    for i, c in enumerate(p["convs"]):
        x = L.leaky_relu(_conv2d_nchw(c, x, (3, 1) if i < 4 else (1, 1), (2, 0)), LRELU_SLOPE)
        fmap.append(x.permute(0, 2, 3, 1))
    x = _conv2d_nchw(p["conv_post"], x, (1, 1), (1, 0))
    fmap.append(x.permute(0, 2, 3, 1))
    return x.reshape(b, -1), fmap


def mpd(params, y, y_hat):
    """Returns (real_scores, gen_scores, real_fmaps, gen_fmaps)."""
    rs, gs, fr, fg = [], [], [], []
    for p, period in zip(params["discriminators"], _MPD_PERIODS):
        r, fmap_r = _disc_p(p, y, period)
        g, fmap_g = _disc_p(p, y_hat, period)
        rs.append(r); gs.append(g); fr.append(fmap_r); fg.append(fmap_g)
    return rs, gs, fr, fg


_MSD_SPECS = [  # (c_out, kernel, stride, groups, padding)
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
]


def init_msd(gen: torch.Generator, device=None):
    """Three DiscriminatorS (_MSD_SPECS, grouped convs); weights [K, I/g, O]
    N(0, 0.02^2), zero biases, conv_post 1024 -> 1 k3 as conv1d_init."""
    device = device or gen.device
    ds = []
    for _ in range(3):
        convs, cin = [], 1
        for cout, k, _, g, _ in _MSD_SPECS:
            convs.append({"w": _normal(gen, (k, cin // g, cout), device), "b": torch.zeros(cout, device=device)})
            cin = cout
        ds.append({"convs": convs, "conv_post": conv1d_init(gen, 1024, 1, 3, device=device)})
    return {"discriminators": ds}


def _conv1d_nct(p, x, stride=1, padding=0, groups=1):
    """x [B, C, T] with WIO weights [K, I/g, O]."""
    return F.conv1d(x, p["w"].to(x.dtype).permute(2, 1, 0), p["b"].to(x.dtype), stride=stride,
                    padding=padding, groups=groups)


def _disc_s(p, x):
    """DiscriminatorS (hifi-gan/models.py:191-216). x [B, T] -> (score
    [B, n], fmaps [B, T', C])."""
    x = x[:, None]
    fmap = []
    for c, (_, _, s, g, pd) in zip(p["convs"], _MSD_SPECS):
        x = L.leaky_relu(_conv1d_nct(c, x, s, pd, g), LRELU_SLOPE)
        fmap.append(x.transpose(1, 2))
    x = _conv1d_nct(p["conv_post"], x, padding=1)
    fmap.append(x.transpose(1, 2))
    return x.reshape(x.shape[0], -1), fmap


def _avgpool4_2(x):
    """AvgPool1d(4, 2, padding=2) on [B, T], the zero padding counted in the
    average (count_include_pad, hifi-gan/models.py:227-230)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


def msd(params, y, y_hat):
    rs, gs, fr, fg = [], [], [], []
    for i, p in enumerate(params["discriminators"]):
        if i != 0:
            y = _avgpool4_2(y)
            y_hat = _avgpool4_2(y_hat)
        r, fmap_r = _disc_s(p, y)
        g, fmap_g = _disc_s(p, y_hat)
        rs.append(r); gs.append(g); fr.append(fmap_r); fg.append(fmap_g)
    return rs, gs, fr, fg


# ---------------------------------------------------------------------------
# losses (hifi-gan/models.py:251-282)


def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(real_outs, gen_outs):
    loss = 0.0
    for dr, dg in zip(real_outs, gen_outs):
        loss = loss + torch.mean(torch.square(1 - dr)) + torch.mean(torch.square(dg))
    return loss


def generator_adv_loss(gen_outs):
    loss = 0.0
    for dg in gen_outs:
        loss = loss + torch.mean(torch.square(1 - dg))
    return loss
