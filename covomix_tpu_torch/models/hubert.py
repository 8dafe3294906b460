"""HuBERT semantic tokenizer, 16 kHz wav -> 50 Hz k-means unit ids (port of
covomix_tpu/models/hubert.py, the inference slice of the fairseq fork).

  * conv frontend (wav2vec2.py:844-922): 7 strided Conv1d layers
    [(512,10,5)] + [(512,3,2)]*4 + [(512,2,2)]*2 without bias (320x
    downsampling), group norm (one group per channel, over time) on the
    first layer, GELU;
  * features -> LayerNorm -> proj 512 -> 768 -> conv positional embedding
    (k 128, groups 16, SamePad trims one frame for even k, GELU) ->
    LayerNorm -> post-LN encoder layers [x += MHA(x); LN; x += FFN(x); LN],
    the hidden state after `output_layer` (12 for CoVoMix tokens);
  * k-means (dump_km_label.py:37-50): argmin_c ||x||^2 - 2 x.c + ||c||^2
    over 500 centroids, one matmul and an argmin;
  * chunks of 1.6 M samples (100 s), as HubertFeatureReader reads them.

Padded batches: `valid_samples` keeps the first group norm's statistics to
each row's true samples and `padding_mask` (a prefix mask) zeroes padded
frames before the positional conv and masks them out of attention, so the
ids over a row's valid frames equal its exact-length extraction. The
encoder's attention takes the flash kernel on the card from 512 frames on
(non-causal, no rotary, per-row `valid_len`), `layers.attend` below that."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.layers import conv1d_init, layernorm_init, linear_init
from covomix_tpu_torch.ops.flash_attention import attend_flash_or_xla


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    # conv frontend: (dim, kernel, stride) per layer (hubert.py:108-112 default)
    conv_layers: tuple = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 2, 2), (512, 2, 2))
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_dim: int = 3072
    encoder_heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    output_layer: int = 12          # 1-based tap for CoVoMix tokens
    sample_rate: int = 16000
    normalize: bool = False         # task cfg `normalize` (layer-norm the wav)
    max_chunk: int = 1_600_000      # samples per chunk (100 s)
    num_units: int = 500

    @property
    def downsample(self) -> int:
        d = 1
        for _, _, s in self.conv_layers:
            d *= s
        return d


def init(gen: torch.Generator, cfg: HubertConfig, device=None):
    """Random parameters drawn from `gen` (the JAX package's names, shapes
    and bounds; on gen's device unless `device`)."""
    device = device or gen.device
    d = cfg.encoder_embed_dim
    c0, c_last = cfg.conv_layers[0][0], cfg.conv_layers[-1][0]
    p = {
        "conv_layers": [],
        "fe_group_norm": layernorm_init(c0, device),
        "layer_norm": layernorm_init(c_last, device),
        "post_extract_proj": linear_init(gen, c_last, d, device=device),
        "pos_conv": conv1d_init(gen, d, d, cfg.conv_pos, groups=cfg.conv_pos_groups, device=device),
        "encoder_layer_norm": layernorm_init(d, device),
        "layers": [],
        "kmeans": torch.randn(cfg.num_units, d, generator=gen, device=device),
    }
    c_in = 1
    for dim, k, _ in cfg.conv_layers:
        p["conv_layers"].append(conv1d_init(gen, c_in, dim, k, bias=False, device=device))
        c_in = dim
    for _ in range(cfg.encoder_layers):
        p["layers"].append({
            "q": linear_init(gen, d, d, device=device),
            "k": linear_init(gen, d, d, device=device),
            "v": linear_init(gen, d, d, device=device),
            "out": linear_init(gen, d, d, device=device),
            "attn_ln": layernorm_init(d, device),
            "fc1": linear_init(gen, d, cfg.encoder_ffn_dim, device=device),
            "fc2": linear_init(gen, cfg.encoder_ffn_dim, d, device=device),
            "final_ln": layernorm_init(d, device),
        })
    return p


def conv_frontend(params, cfg: HubertConfig, wav: torch.Tensor, dtype=torch.float32, valid_samples=None):
    """[B, T] waveform -> [B, T/320, 512] features. `valid_samples` [B]: the
    true sample count per row of a padded batch; the first layer's group
    norm then takes its statistics over each row's valid frames only (the
    later convs are local, so valid frames see only valid frames)."""
    x = wav.to(dtype)[..., None]
    t_valid = None if valid_samples is None else torch.as_tensor(valid_samples, dtype=torch.int64,
                                                                 device=wav.device)
    for i, ((dim, k, s), lp) in enumerate(zip(cfg.conv_layers, params["conv_layers"])):
        x = L.conv1d(lp, x, stride=s, padding="VALID")
        if t_valid is not None:
            t_valid = torch.clamp(torch.div(t_valid - k, s, rounding_mode="floor") + 1, min=0)
        if i == 0:
            lm = None if t_valid is None else torch.arange(x.shape[1], device=x.device)[None, :] < t_valid[:, None]
            x = L.groupnorm(params["fe_group_norm"], x, num_groups=dim, length_mask=lm)
        x = L.gelu(x)
    return x


def _encoder_layer(lp, x, heads, key_mask=None, valid_frames=None):
    """Post-LN transformer layer. With `valid_frames` ([B], the prefix lengths
    of key_mask) attention goes through the flash dispatch with a per-row
    valid_len; an arbitrary key_mask takes `layers.attend`."""
    residual = x
    q = L.split_heads(L.linear(lp["q"], x), heads)
    k = L.split_heads(L.linear(lp["k"], x), heads)
    v = L.split_heads(L.linear(lp["v"], x), heads)
    if key_mask is None or valid_frames is not None:
        att = attend_flash_or_xla(q, k, v, valid_len=valid_frames)
    else:
        att = attend_flash_or_xla(q, k, v, key_mask=key_mask)
    x = residual + L.linear(lp["out"], L.merge_heads(att))
    x = L.layernorm(lp["attn_ln"], x)
    residual = x
    x = residual + L.linear(lp["fc2"], L.gelu(L.linear(lp["fc1"], x)))
    return L.layernorm(lp["final_ln"], x)


def num_output_frames(cfg: HubertConfig, num_samples: int) -> int:
    """Frames the VALID-padded conv stack yields for num_samples."""
    t = num_samples
    for _, k, s in cfg.conv_layers:
        t = (t - k) // s + 1
    return t


def extract_features(params, cfg: HubertConfig, wav: torch.Tensor, *, output_layer: Optional[int] = None,
                     padding_mask=None, valid_samples=None, valid_frames=None, dtype=torch.float32):
    """[B, T] 16 kHz waveform -> [B, frames, 768] hidden state after
    `output_layer`. padding_mask [B, frames] True = valid; valid_samples [B]
    true sample counts; valid_frames [B] true frame counts (when
    padding_mask is a prefix mask: attention then takes the flash route)."""
    output_layer = output_layer or cfg.output_layer
    feats = conv_frontend(params, cfg, wav, dtype, valid_samples=valid_samples)
    feats = L.layernorm(params["layer_norm"], feats)
    x = L.linear(params["post_extract_proj"], feats)
    if padding_mask is not None:
        x = x * padding_mask[..., None].to(x.dtype)
    pos = L.conv1d(params["pos_conv"], x, padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    if cfg.conv_pos % 2 == 0:
        pos = pos[:, :-1]
    x = L.layernorm(params["encoder_layer_norm"], x + L.gelu(pos))
    for li in range(output_layer):
        x = _encoder_layer(params["layers"][li], x, cfg.encoder_heads, key_mask=padding_mask,
                           valid_frames=valid_frames)
    return x


def kmeans_assign(params, feats: torch.Tensor) -> torch.Tensor:
    """[..., 768] features -> unit ids: argmin ||x||^2 - 2 x C^T + ||c||^2."""
    c = params["kmeans"].to(feats.dtype)
    c_sq = (c * c).sum(dim=-1)
    x_sq = (feats * feats).sum(dim=-1, keepdim=True)
    return torch.argmin(x_sq - 2.0 * (feats @ c.T) + c_sq, dim=-1)


@torch.no_grad()
def wav2units_batch(params, cfg: HubertConfig, wav: torch.Tensor, padding_mask=None, valid_samples=None,
                    dtype=torch.float32) -> torch.Tensor:
    """One [B, T] batch -> [B, frames] unit ids (the counterpart of the JAX
    package's `wav2units_jit`). For padded rows pass both padding_mask (a
    prefix mask over frames) and valid_samples; the ids over each row's
    valid frames then equal its exact-length extraction. With
    cfg.normalize the caller normalizes each whole utterance first."""
    valid_frames = None if padding_mask is None else padding_mask.to(torch.int32).sum(dim=-1)
    feats = extract_features(params, cfg, wav, padding_mask=padding_mask, valid_samples=valid_samples,
                             valid_frames=valid_frames, dtype=dtype)
    return kmeans_assign(params, feats)


def wav2units(params, cfg: HubertConfig, wav: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """A mono 16 kHz wav of any length -> int64 unit ids, on the parameters'
    device. Chunks of cfg.max_chunk samples (hubert_feature_reader.py:57-77);
    a chunk shorter than the conv stack's receptive field yields no frames
    and is skipped; a chunk that is not a whole number of seconds is padded
    to one with a padding mask, so a few shapes serve every length."""
    wav = np.asarray(wav, np.float32)
    if cfg.normalize:
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
    device = params["kmeans"].device
    bucket = cfg.sample_rate   # 1 s
    out = []
    for start in range(0, len(wav), cfg.max_chunk):
        chunk = wav[start: start + cfg.max_chunk]
        frames = num_output_frames(cfg, len(chunk))
        if frames < 1:
            continue
        if len(chunk) % bucket:
            padded = ((len(chunk) + bucket - 1) // bucket) * bucket
            mask = torch.zeros((1, num_output_frames(cfg, padded)), dtype=torch.bool, device=device)
            mask[:, :frames] = True
            x = torch.from_numpy(np.pad(chunk, (0, padded - len(chunk)))[None]).to(device)
            ids = wav2units_batch(params, cfg, x, padding_mask=mask,
                                  valid_samples=torch.tensor([len(chunk)], device=device), dtype=dtype)
            out.append(ids[0, :frames].cpu().numpy())
        else:
            out.append(wav2units_batch(params, cfg, torch.from_numpy(chunk[None]).to(device), dtype=dtype)[0]
                       .cpu().numpy())
    if not out:
        return np.zeros((0,), np.int64)
    return np.concatenate(out).astype(np.int64)
