"""The data-parallel train step (port of covomix_tpu/parallel/train_step.py,
its pure-dp form).

JAX pins the batch to 'dp', replicates the parameters and lets XLA emit the
gradient all-reduce. Here each rank computes the backward of its rows, then
one all-reduce of one flat bucket (every gradient, and the loss) makes the
mean over the ranks, and the norm, clipping, Adam and EMA of
`train.loop.make_train_step` run on it identically on every rank. The loss
functions draw their random numbers for the global batch and keep the
rank's rows (`mesh=`), so a dp=N step is the one-device step on the global
batch."""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from covomix_tpu_torch.parallel.mesh import Mesh, replicate
from covomix_tpu_torch.train import loop
from covomix_tpu_torch.util.misc import tree_leaves

GRAD_SYNCS = 0         # gradient all-reduces launched (one flat bucket each)
GRAD_SYNC_BYTES = 0    # the bytes they carried


@torch.no_grad()
def sync_grads(mesh: Mesh, grads, *scalars) -> list:
    """The mean over the ranks of every gradient (in place) and of the
    0-dim `scalars` (returned): one all-reduce of one flat bucket. Without a
    process group, the scalars as they are."""
    global GRAD_SYNCS, GRAD_SYNC_BYTES
    if not mesh.collective:
        return list(scalars)
    dtype = grads[0].dtype
    flat = torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1).to(dtype) for s in scalars])
    dist.all_reduce(flat)
    GRAD_SYNCS += 1
    GRAD_SYNC_BYTES += flat.numel() * flat.element_size()
    flat.div_(mesh.dp)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
    return list(flat[offset:].unbind())


def make_sharded_train_step(loss_fn: Callable, cfg: loop.TrainConfig, mesh: Mesh):
    """`loop.make_train_step` with the gradients and the loss averaged over
    the ranks before the global norm: step(state, batch, generator) ->
    {"loss": the global loss, "grad_norm": the norm of the averaged
    gradients}. `batch` holds this rank's rows (`shard_batch`), and
    `loss_fn` draws for the global batch (the loss adapters' `mesh=`)."""

    def grad_sync(grads, loss):
        return sync_grads(mesh, grads, loss)[0]

    return loop.make_train_step(loss_fn, cfg, grad_sync=grad_sync)


def init_sharded_state(params, cfg: loop.TrainConfig, mesh: Mesh) -> loop.TrainState:
    """Rank 0's parameters on every rank (one broadcast), then the train
    state over them (the EMA a copy)."""
    replicate(mesh, tree_leaves(params))
    return loop.init_train_state(params, cfg)


def replicate_state(mesh: Mesh, state) -> None:
    """Rank 0's TrainState or train.gan.GanState on every rank, after a
    resume: parameters (and the spectral buffers), EMA, the Adam moments
    present."""
    if hasattr(state, "opt_d"):
        tensors = tree_leaves([state.gen_params, state.mpd_params, state.msd_params])
        opts = (state.opt_g, state.opt_d)
    else:
        tensors = tree_leaves([state.params, state.ema_params])
        opts = (state.optimizer,)
    for opt in opts:
        for st in opt.state.values():
            tensors += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
    replicate(mesh, tensors)


def shard_batch(mesh: Mesh, batch: dict, accum: bool = False) -> dict:
    """This rank's rows of a global host batch: axis 0, or axis 1 of grad
    accumulation's [A, B, ...] leaves. The global batch must divide by dp."""
    axis = 1 if accum else 0
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        if n % mesh.dp:
            raise ValueError(f"batch {k!r} of {n} rows does not divide by dp={mesh.dp}")
        index = [slice(None)] * v.ndim
        index[axis] = mesh.rows(n // mesh.dp)
        out[k] = v[tuple(index)]
    return out
