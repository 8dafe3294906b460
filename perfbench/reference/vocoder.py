"""Reference HiFi-GAN generator (ResBlock1), float32.

conv_pre (k 7) -> per stage: leaky ReLU 0.1, transposed conv (stride u,
kernel k, padding (k - u) / 2), the mean of the stage's ResBlock1 branches
(each dilation: leaky ReLU 0.1, dilated conv, leaky ReLU 0.1, conv, residual)
-> leaky ReLU 0.01 -> conv_post (k 7) -> tanh."""

from __future__ import annotations

import torch

from perfbench.reference import nn
from perfbench.reference.nn import F32, Precision


def _same(k: int, d: int = 1):
    p = (k * d - d) // 2
    return (p, p)


@torch.no_grad()
def generate(params, c: dict, mel, q: Precision = F32):
    """mel [B, T, num_mels] -> waveform [B, samples]."""
    with nn.strict_f32():
        x = nn.conv1d(params["conv_pre"], mel.float(), (3, 3), prec=q)
        n = len(c["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
            x = nn.conv_transpose1d(params["ups"][i], nn.leaky_relu(x, 0.1), u, (k - u) // 2, prec=q)
            acc = 0.0
            for j, (kr, dr) in enumerate(zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"])):
                blk, y = params["resblocks"][i * n + j], x
                for c1, c2, d in zip(blk["convs1"], blk["convs2"], dr):
                    h = nn.conv1d(c1, nn.leaky_relu(y, 0.1), _same(kr, d), dilation=d, prec=q)
                    y = y + nn.conv1d(c2, nn.leaky_relu(h, 0.1), _same(kr), prec=q)
                acc = acc + y
            x = acc / n
        x = nn.conv1d(params["conv_post"], nn.leaky_relu(x, 0.01), (3, 3), prec=q)
        return torch.tanh(x)[..., 0]


def output_length(c: dict, frames: int) -> int:
    t = frames
    for u, k in zip(c["upsample_rates"], c["upsample_kernel_sizes"]):
        t = (t - 1) * u - 2 * ((k - u) // 2) + k
    return t
