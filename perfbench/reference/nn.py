"""Plain PyTorch building blocks of the benchmark's reference models.

Everything computes in float32 with TF32 off (`strict_f32`), attention as an
explicit softmax, convolutions through `torch.nn.functional`. `Precision`
says how the operands of every product (linear layers, attention, the tied
logits, convolutions) are rounded before the f32 product: not at all
("f32"), or to float8 e4m3 with one scale per tensor ("fp8"), the control
that stands one precision below the configurations' bf16.

Layouts are those of the benchmark's weight trees (`spec.py`): linear `w`
[in, out], conv `w` [K, C_in / groups, C_out], transposed conv `w`
[K, C_in, C_out], activations [B, T, C], attention [B, H, T, dh]."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """cuBLAS and cuDNN in full f32 (no TF32) inside the block."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = prev


class Precision:
    """Rounding of product operands: "f32" (none) or "fp8" (e4m3, the
    tensor scaled so that its largest magnitude maps to 448). Under
    autograd the rounding passes the gradient through unrounded (the
    products' backward then reads the rounded operands, as an fp8 forward
    with higher-precision gradients does)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}: f32 or fp8")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.name == "f32":
            return x
        with torch.no_grad():
            scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
            rounded = (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (rounded - x).detach()


F32 = Precision("f32")


def linear(p, x, q: Precision = F32):
    y = q(x) @ q(p["w"])
    if "b" in p:
        y = y + p["b"].float()
    return y


def rmsnorm(gamma, x):
    """x / max(||x||, 1e-12) * sqrt(d) * gamma."""
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
    return x / n * math.sqrt(x.shape[-1]) * gamma.float()


def gelu(x):
    return F.gelu(x, approximate="none")


def split_heads(x, heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def inv_freq(dim_head: int, device) -> torch.Tensor:
    return 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2, dtype=torch.float32, device=device) / dim_head))


def rotary_halfsplit(x, positions):
    """Rotate [..., T, dh] by angles pos * f, the frequencies repeated as two
    halves; rotate_half swaps the halves with a sign."""
    f = positions.float()[:, None] * inv_freq(x.shape[-1], x.device)[None, :]
    f = torch.cat([f, f], dim=-1)
    d = x.shape[-1] // 2
    rot = torch.cat([-x[..., d:], x[..., :d]], dim=-1)
    return x * torch.cos(f) + rot * torch.sin(f)


def rotary_interleaved(x, positions):
    """The same with each frequency repeated for a pair of neighbouring
    channels; rotate_half maps (x0, x1) to (-x1, x0)."""
    f = positions.float()[:, None] * inv_freq(x.shape[-1], x.device)[None, :]
    f = torch.repeat_interleave(f, 2, dim=-1)
    pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * torch.cos(f) + rot * torch.sin(f)


def attention(q, k, v, key_valid=None, causal: bool = False, prec: Precision = F32):
    """softmax(q k^T / sqrt(dh)) v; key_valid [B, Tk] bool; causal: query i
    sees keys j <= i (equal lengths)."""
    s = (prec(q) @ prec(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_valid is not None:
        s = s.masked_fill(~key_valid[:, None, None, :], float("-inf"))
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=s.device).triu(1), float("-inf"))
    return prec(torch.softmax(s, dim=-1)) @ prec(v)


def conv1d(p, x, padding, dilation: int = 1, groups: int = 1, prec: Precision = F32):
    """x [B, T, C_in] -> [B, T', C_out]; padding (left, right)."""
    w = prec(p["w"]).permute(2, 1, 0)                        # [C_out, C_in / g, K]
    y = F.conv1d(F.pad(prec(x).transpose(1, 2), padding), w, dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + p["b"].float()
    return y


def conv_transpose1d(p, x, stride: int, padding: int, prec: Precision = F32):
    w = prec(p["w"]).permute(1, 2, 0)                        # [C_in, C_out, K]
    y = F.conv_transpose1d(prec(x).transpose(1, 2), w, stride=stride, padding=padding).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].float()
    return y


def leaky_relu(x, slope: float):
    return torch.where(x >= 0, x, x * slope)
