"""PyTorch/CUDA port of covomix_tpu for NVIDIA Hopper (H100).

The JAX package `covomix_tpu` is the reference; this package mirrors its
module layout, parameter names and tensor layouts ([B, T, D] activations,
[B, H, T, dh] attention, linear `w` [in, out], conv `w` [K, Cin/g, Cout]) so
weights carry across without transposes. It imports torch and never jax or
anything of covomix_tpu.

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for `cuda` on a machine without it raises (`resolve_device`)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda. Raises if cuda is asked for and is not available: the
    port never carries on on the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' explicitly to run on the CPU")
    return dev
