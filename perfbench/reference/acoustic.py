"""Reference flow-matching acoustic model (VoSingle / VoMix) and its sampler.

Field: cat[x_t, phoneme embedding(s), condition mel] -> Linear -> + GELU of a
depthwise positional conv (frames past valid_len zeroed before it) ->
`depth` layers with U-Net skips (the second half concatenates the matching
first-half input and projects it back), each adaptive RMSNorm on the flow
time's embedding (learned sinusoid -> Linear -> SiLU), self-attention with
half-split rotary over the valid frames, adaptive RMSNorm, GELU MLP ->
RMSNorm -> Linear to the mel. Sampler: 16 midpoint steps from t = 0 to 1;
classifier-free guidance evaluates the field with the condition and with
the null condition (null mel, null phoneme id) and combines
out * (1 + s) - null * s."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import nn
from perfbench.reference.nn import F32, Precision
from perfbench.reference.spec import acoustic_dims


def _adaptive_rmsnorm(p, x, temb, q):
    gamma = nn.linear(p["to_gamma"], temb, q)[:, None, :]
    beta = nn.linear(p["to_beta"], temb, q)[:, None, :]
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
    return x / n * math.sqrt(x.shape[-1]) * gamma + beta


def field(params, c: dict, x, phonemes, cond, times, drop, valid_len, q: Precision = F32):
    """Vector field [B, T, mel_dim]. x [B, T, mel_dim]; phonemes [B, T] or
    [B, T, 2]; cond [B, T, dim_in]; times [B]; drop [B] bool (null
    condition); valid_len [B] (frames at or past it are padding)."""
    b, t = x.shape[:2]
    dev = x.device
    ph = torch.where(drop.view(-1, *([1] * (phonemes.dim() - 1))),
                     torch.full_like(phonemes, c["num_phoneme_tokens"]), phonemes)
    cond = torch.where(drop[:, None, None], params["null_cond"].float()[None, None, :], cond.float())
    emb = params["phoneme_emb"]["w"].float()[ph.long()].reshape(b, t, -1)
    h = nn.linear(params["to_embed"], torch.cat([x.float(), emb, cond], dim=-1), q)
    keep = torch.arange(t, device=dev)[None, :] < valid_len[:, None]
    pad = c["conv_pos_kernel"] // 2
    h = h + nn.gelu(nn.conv1d(params["conv_embed"], h * keep[..., None], (pad, pad), groups=c["dim"], prec=q))
    freqs = times.float()[:, None] * params["sinu_weights"].float()[None, :] * 2 * math.pi
    temb = F.silu(nn.linear(params["time_mlp"], torch.cat([torch.sin(freqs), torch.cos(freqs)], dim=-1), q))
    pos = torch.arange(t, device=dev)
    skips = []
    for i, lp in enumerate(params["layers"]):
        if i < c["depth"] // 2:
            skips.append(h)
        else:
            h = nn.linear(lp["skip"], torch.cat([h, skips.pop()], dim=-1), q)
        a = _adaptive_rmsnorm(lp["attn_norm"], h, temb, q)
        qh, k, v = (nn.split_heads(z, c["heads"]) for z in torch.chunk(nn.linear(lp["qkv"], a, q), 3, dim=-1))
        att = nn.attention(nn.rotary_halfsplit(qh, pos), nn.rotary_halfsplit(k, pos), v, key_valid=keep, prec=q)
        h = h + nn.linear(lp["attn_out"], nn.merge_heads(att), q)
        f = _adaptive_rmsnorm(lp["ff_norm"], h, temb, q)
        h = h + nn.linear(lp["ff2"], nn.gelu(nn.linear(lp["ff1"], f, q)), q)
    return nn.linear(params["to_pred"], nn.rmsnorm(params["final_norm"]["gamma"], h), q)


@torch.no_grad()
def sample(params, c: dict, y0, phonemes, cond, valid_len, cond_scale: float, steps: int = 16,
           q: Precision = F32):
    """Midpoint integration of the guided field from y0 [B, T, mel_dim]."""
    b = y0.shape[0]
    dev = y0.device
    two = lambda z: torch.cat([z, z], dim=0)
    drop = torch.cat([torch.zeros(b, dtype=torch.bool, device=dev), torch.ones(b, dtype=torch.bool, device=dev)])
    ph2, c2, vl2 = two(phonemes), two(cond), two(valid_len)

    def guided(y, t):
        out = field(params, c, two(y), ph2, c2, torch.full((2 * b,), t, device=dev), drop, vl2, q)
        return out[:b] * (1 + cond_scale) - cond_scale * out[b:]

    h = 1.0 / steps
    y = y0.float()
    with nn.strict_f32():
        for i in range(steps):
            k1 = guided(y, i * h)
            y = y + h * guided(y + 0.5 * h * k1, i * h + 0.5 * h)
    return y


def mel_dim(c: dict) -> int:
    return acoustic_dims(c)[0]
