"""Seeded weights made on the device: one uniform and one normal draw for a
whole tree (`reference/spec.py` leaves), cut into the leaves and scaled.
The same tree goes to the program and to the reference."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.spec import Leaf


def _leaves(tree, out):
    if isinstance(tree, Leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        for v in tree:
            _leaves(v, out)
    return out


def _fill(tree, take):
    if isinstance(tree, Leaf):
        return take(tree)
    if isinstance(tree, dict):
        return {k: _fill(v, take) for k, v in tree.items()}
    return [_fill(v, take) for v in tree]


def make(spec, generator: torch.Generator, device) -> dict:
    """The tree of f32 tensors that `spec` describes, drawn from `generator`
    (on `device`): uniform leaves from one torch.rand call, normal leaves
    from one torch.randn call, in the tree's order."""
    leaves = _leaves(spec, [])
    n_u = sum(int(np.prod(x.shape)) for x in leaves if x.kind == "u")
    n_n = sum(int(np.prod(x.shape)) for x in leaves if x.kind == "n")
    pools = {"u": torch.rand(n_u, generator=generator, device=device).mul_(2).sub_(1),
             "n": torch.randn(n_n, generator=generator, device=device)}
    at = {"u": 0, "n": 0}

    def take(leaf: Leaf):
        size = int(np.prod(leaf.shape))
        if leaf.kind in pools:
            t = pools[leaf.kind][at[leaf.kind]:at[leaf.kind] + size].view(leaf.shape)
            at[leaf.kind] += size
            if not (leaf.kind == "n" and leaf.bound == 1.0):
                t.mul_(leaf.bound)
            if leaf.zero_last_rows:
                t[-leaf.zero_last_rows:] = 0
            return t
        return torch.full(leaf.shape, 1.0 if leaf.kind == "1" else 0.0, device=device)

    return _fill(spec, take)

