"""Lightweight and dynamic convolutions (Wu et al. 2019; port of
covomix_tpu/ops/lightconv.py). Unused by CoVoMix itself; the JAX package
computes both with XLA ops and no Pallas kernel, so plain torch ops are
their port.

  * light_conv: a depthwise convolution whose kernel is shared across each
    of H head groups and softmax-normalized over the taps: one
    `F.conv1d(groups=C)` with the head kernel repeated per channel.
  * dynamic_conv: per-position kernels predicted from the input: the K-tap
    window stack and an einsum.

Both use fairseq's `padding_l` (padding_l zeros on the left, K - 1 -
padding_l on the right; causal: padding_l = K - 1). On CUDA the f32
convolution follows the caller's `torch.backends.cudnn.allow_tf32`."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def light_conv(x: torch.Tensor, weights: torch.Tensor, *, padding_l: int, softmax: bool = True) -> torch.Tensor:
    """x [B, T, C]; weights [H, K] with H | C. Returns [B, T, C]: channel c
    convolved with the (optionally softmaxed) kernel of head c // (C / H),
    out[t] = sum_k w[k] x[t - padding_l + k]."""
    b, t, c = x.shape
    h, k = weights.shape
    assert c % h == 0, (c, h)
    w = torch.softmax(weights.float(), dim=-1) if softmax else weights
    kern = w.repeat_interleave(c // h, dim=0)[:, None, :].to(x.dtype)      # [C, 1, K]
    xp = F.pad(x.transpose(1, 2), (padding_l, k - 1 - padding_l))
    return F.conv1d(xp, kern, groups=c).transpose(1, 2)


def dynamic_conv(x: torch.Tensor, dyn_weights: torch.Tensor, *, padding_l: int, softmax: bool = True) -> torch.Tensor:
    """x [B, T, C]; dyn_weights [B, T, H, K] (per-position kernels). Returns
    [B, T, C]: out[b, t, c] = sum_k w[b, t, head(c), k] x[b, t - padding_l + k, c]."""
    b, t, c = x.shape
    _, _, h, k = dyn_weights.shape
    assert c % h == 0, (c, h)
    w = torch.softmax(dyn_weights.float(), dim=-1) if softmax else dyn_weights
    xp = F.pad(x, (0, 0, padding_l, k - 1 - padding_l))
    windows = torch.stack([xp[:, i: i + t] for i in range(k)], dim=2)     # [B, T, K, C]
    win = windows.reshape(b, t, k, h, c // h)
    return torch.einsum("bthk,btkhg->bthg", w.to(x.dtype), win).reshape(b, t, c)
