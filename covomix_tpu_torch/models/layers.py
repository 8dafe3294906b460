"""Shared neural-net building blocks over parameter dicts (port of
covomix_tpu/models/layers.py).

Conventions kept from the JAX package so weights carry across unchanged:
  * activations [B, T, D]; attention tensors [B, H, T, dh]
  * linear `w` [in, out]; conv `w` [K, C_in/groups, C_out] ('WIO');
    conv-transpose `w` [K, C_in, C_out]
  * parameters stay f32; compute dtype follows the activations; norms run in
    f32 regardless of the compute dtype."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# dense / embedding / convolutions


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding(p, ids, dtype=torch.float32):
    return p["w"].to(dtype)[ids.long()]


def _pad_arg(padding, k: int, dilation: int):
    """'SAME' | 'VALID' | int | (lo, hi) -> (lo, hi) for stride-1 convs."""
    if padding == "SAME":
        total = dilation * (k - 1)
        return total // 2, total - total // 2
    if padding == "VALID":
        return 0, 0
    if isinstance(padding, int):
        return padding, padding
    return tuple(padding)


def conv1d(p, x, stride: int = 1, padding="SAME", groups: int = 1, rhs_dilation: int = 1):
    """x [B, T, C] with WIO weights [K, C_in/groups, C_out]."""
    w = p["w"].to(x.dtype)
    k = w.shape[0]
    lo, hi = _pad_arg(padding, k, rhs_dilation)
    xt = F.pad(x.transpose(1, 2), (lo, hi))
    y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride, dilation=rhs_dilation, groups=groups)
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def depthwise_conv1d(p, x, padding: int):
    """Depthwise 1-D conv (groups == channels), weights [K, 1, C]: K shifted
    multiply-adds over the zero-padded input, the JAX package's formulation
    (same sum order)."""
    k = p["w"].shape[0]
    w = p["w"].to(x.dtype)
    t_out = x.shape[1] + 2 * padding - k + 1
    xp = F.pad(x, (0, 0, padding, padding))
    out = xp[:, :t_out] * w[0, 0]
    for kk in range(1, k):
        out = out + xp[:, kk:kk + t_out] * w[kk, 0]
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def conv_transpose1d(p, x, stride: int, padding: int, kernel: int):
    """Torch ConvTranspose1d semantics, out_len = (T-1)*stride - 2*padding +
    kernel, with weights [K, C_in, C_out]. The JAX package computes it as an
    input-dilated convolution with the flipped kernel padded by
    kernel-1-padding; that is the same sum and length as conv_transpose1d."""
    assert p["w"].shape[0] == kernel
    w = p["w"].to(x.dtype).permute(1, 2, 0)            # [C_in, C_out, K]
    y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride, padding=padding).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# norms


def _l2_normalize(xf):
    """x * rsqrt(max(||x||^2, 1e-24)) == x / max(||x||, 1e-12)."""
    sq = torch.sum(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(torch.clamp(sq, min=1e-24))


def rmsnorm(p, x):
    """F.normalize(x, dim=-1) * sqrt(d) * gamma, computed in f32."""
    xf = x.float()
    normed = _l2_normalize(xf) * math.sqrt(x.shape[-1])
    return (normed * p["gamma"]).to(x.dtype)


def adaptive_rmsnorm(p, x, cond):
    """cond [B, cond_dim] -> per-example scale/shift, computed in f32."""
    xf = x.float()
    normed = _l2_normalize(xf) * math.sqrt(x.shape[-1])
    gamma = linear(p["to_gamma"], cond.float())[:, None, :]
    beta = linear(p["to_beta"], cond.float())[:, None, :]
    return (normed * gamma + beta).to(x.dtype)


def layernorm(p, x, eps: float = 1e-5):
    """LayerNorm over the last dim, computed in f32 (gamma / beta affine)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["gamma"] + p["beta"]).to(x.dtype)


def groupnorm(p, x, num_groups: int, eps: float = 1e-5, length_mask=None):
    """x [B, T, C]; statistics per group over time and the group's channels,
    in f32, affine per channel (fairseq Fp32GroupNorm). `length_mask` [B, T]
    bool restricts the statistics to the valid timesteps, so a padded row
    gives what its exact-length run gives."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, num_groups, c // num_groups)
    if length_mask is None:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    else:
        m = length_mask[:, :, None, None].float()
        count = torch.clamp(m.sum(dim=(1, 3), keepdim=True), min=1.0) * (c // num_groups)
        mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
        var = (((xf - mean) ** 2) * m).sum(dim=(1, 3), keepdim=True) / count
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (y * p["gamma"] + p["beta"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings: halfsplit (acoustic) and interleaved (T2S) conventions


def rotary_freqs(dim_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim_head, 2, dtype=torch.float32, device=device) / dim_head))


def rotary_halfsplit(positions, inv_freq, t):
    """freqs = cat((p*f, p*f)); rotate_half = split in two. positions [T];
    t [..., T, dh]."""
    freqs = positions[:, None].float() * inv_freq[None, :]
    freqs = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(freqs).to(t.dtype), torch.sin(freqs).to(t.dtype)
    d = t.shape[-1] // 2
    rot = torch.cat([-t[..., d:], t[..., :d]], dim=-1)
    return t * cos + rot * sin


def rotary_interleaved(positions, inv_freq, t):
    """Pairwise-repeated freqs; rotate_half maps (x0, x1) -> (-x1, x0).
    positions [T], or any shape that broadcasts against t's leading dims
    with T last (per-row positions: [B, 1, T]); t [..., T, dh]."""
    freqs = positions[..., None].float() * inv_freq
    freqs = torch.repeat_interleave(freqs, 2, dim=-1)
    cos, sin = torch.cos(freqs).to(t.dtype), torch.sin(freqs).to(t.dtype)
    tp = t.reshape(t.shape[:-1] + (t.shape[-1] // 2, 2))
    rot = torch.stack([-tp[..., 1], tp[..., 0]], dim=-1).reshape(t.shape)
    return t * cos + rot * sin


# ---------------------------------------------------------------------------
# attention


def attend(q, k, v, *, key_mask: Optional[torch.Tensor] = None, causal: bool = False,
           q_offset: Optional[int] = None):
    """Scaled dot-product attention, softmax in f32. key_mask [B, Tk] True =
    attend; masked logits are -inf and a fully masked row gives zeros (NaN ->
    0). causal places the queries at the end of the key axis, or from key
    position `q_offset` on when it is given (cached-decode semantics)."""
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bhid,bhjd->bhij", q, k).float() * scale
    tq, tk = q.shape[-2], k.shape[-2]
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    if causal:
        qpos = torch.arange(tq, device=q.device) + ((tk - tq) if q_offset is None else q_offset)
        kpos = torch.arange(tk, device=q.device)
        sim = sim.masked_fill(~(kpos[None, :] <= qpos[:, None]), float("-inf"))
    attn = torch.softmax(sim, dim=-1)
    attn = torch.nan_to_num(attn, nan=0.0)
    return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)


def split_heads(x, heads: int):
    b, t, _ = x.shape
    return x.reshape(b, t, heads, -1).transpose(1, 2)


def merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ---------------------------------------------------------------------------
# activations


def gelu(x):
    """Exact erf under f32+, tanh approximation under sub-f32 dtypes (the JAX
    package's dtype rule)."""
    return F.gelu(x, approximate="tanh" if x.element_size() < 4 else "none")


def geglu(x):
    a, gate = torch.chunk(x, 2, dim=-1)
    return gelu(gate) * a


def leaky_relu(x, slope: float = 0.01):
    return torch.where(x >= 0, x, x * slope)
