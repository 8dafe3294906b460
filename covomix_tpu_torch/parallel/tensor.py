"""Tensor parallelism over the mesh's tp axis: the collectives as autograd
functions, and the helpers the models' tp forward is written with.

JAX shards the matmul weights over 'tp' (parallel/mesh.py) and GSPMD
inserts the collectives. The port writes them out, Megatron-style:

  * `copy_to_tp`: identity forward, all-reduce backward; on the replicated
    input of a block whose weights are split over tp;
  * `reduce_from_tp`: all-reduce forward, identity backward; on the
    partial sums of a row-split projection (its bias added after);
  * `gather_from_tp`: all-gather forward, the rank's slice backward; on an
    activation split over tp that replicated code reads next (the time MLP,
    the vocab-split logits), or on a split leaf read whole (the gather
    form).

An attention block runs the rank's heads where tp divides the heads (its
shards then hold its heads' q, k and v columns) and a feed-forward its
columns; where the split leaves do not line up with a local computation
(heads or GEGLU pairs that tp does not divide), the leaf is gathered before
its use (`full`). Both compute the function of the
unsplit block, as GSPMD does. Partial sums and gradients are added in f32
(16-bit activations are summed after a cast and rounded once).

Each collective runs on the mesh's tp group and counts itself in plain
numbers: `COLLECTIVES` launched, `BYTES` of what they return and
`SECONDS` of host time inside them (the gloo forms return when the sum is
on the device)."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.parallel.mesh import all_gather, unblock

COLLECTIVES = 0
BYTES = 0
SECONDS = 0.0


def active(mesh) -> bool:
    """A tp axis of more than one rank with its collectives."""
    return mesh is not None and mesh.syncs_tp


def divides(mesh, n: int) -> bool:
    """JAX's rule: an axis of n (> 0) is split over tp."""
    return active(mesh) and n > 0 and n % mesh.tp == 0


def _count(t: torch.Tensor, t0: float) -> None:
    global COLLECTIVES, BYTES, SECONDS
    COLLECTIVES += 1
    BYTES += t.numel() * t.element_size()
    SECONDS += time.perf_counter() - t0


def _all_reduce(mesh, x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    y = x.float() if x.element_size() < 4 else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.tp_group)
    y = y.to(x.dtype)
    _count(y, t0)
    return y


def _gather(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    y = all_gather(x, dim, mesh.tp_group, mesh.tp, mesh.tp_rank)
    _count(y, t0)
    return y


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.k = mesh, dim, x.shape[dim]
        return _gather(mesh, x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.tp_rank * ctx.k, ctx.k), None, None


def copy_to_tp(mesh, x):
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(mesh, x):
    return _ReduceFromTP.apply(x, mesh)


def gather_from_tp(mesh, x, dim: int = -1):
    return _GatherFromTP.apply(x, mesh, dim % x.dim())


def enter(mesh, x, split: bool):
    """The replicated input of a block split over tp (`split`)."""
    return copy_to_tp(mesh, x) if split else x


def row_linear(mesh, p, x, split: bool):
    """`layers.linear`, of a row-split projection when `split`: the rank's
    partial sums added over tp, then the (replicated) bias."""
    if not split:
        return L.linear(p, x)
    y = reduce_from_tp(mesh, x @ p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def full_leaf(mesh, w, axis: int, size: int, groups: int = 1):
    """The whole of a leaf whose `axis` has `size` elements when unsplit:
    gathered over tp (its blocks undone) when split, else as it is."""
    axis = axis % w.dim()
    if not active(mesh) or w.shape[axis] == size:
        return w
    return unblock(gather_from_tp(mesh, w, axis), axis, mesh.tp, groups)


def full(mesh, p, axis: int, size: int, groups: int = 1):
    """A linear's parameters whole (the gather form): `w` along `axis`, and
    a bias split with a column-split `w`."""
    if not active(mesh):
        return p
    out = {"w": full_leaf(mesh, p["w"], axis, size, groups)}
    if "b" in p:
        out["b"] = full_leaf(mesh, p["b"], 0, size, groups) if axis % p["w"].dim() == p["w"].dim() - 1 else p["b"]
    return out


def heads_slice(mesh, x, dim: int, heads: int):
    """The rank's heads of a replicated per-head leaf, its gradient summed
    over tp (each rank's covers its heads only)."""
    k = heads // mesh.tp
    return copy_to_tp(mesh, x).narrow(dim, mesh.tp_rank * k, k)
