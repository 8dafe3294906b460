"""The sharded train step (port of covomix_tpu/parallel/train_step.py).

JAX pins the batch to 'dp' and the gradients, parameters and EMA to the
layout of `param_shardings`, and XLA emits the collectives. Here each rank
holds its part of every leaf (`init_sharded_state`: the tp shards, and
under FSDP the dp shards too; Adam moments and EMA live on the same
shards) and computes the backward of its rows; then:

  * the gradients of the leaves that are not split over dp, and the loss,
    are averaged over the dp ranks by one all-reduce of one flat bucket
    (`sync_grads`; pure dp is this alone);
  * under FSDP the parameters split over dp are all-gathered (one bucket)
    before the forward, the whole tree once a step, and their gradients
    reduce-scattered (one bucket) back onto the shards;
  * the global norm sums each shard's squares once: a leaf counts on the
    ranks that hold distinct parts of it, a replicated one on one rank
    (`sharded_norm`);
  * clipping, Adam and EMA run on the shards, as `train.loop` runs them on
    the whole tree.

On a dp x pp or dp x sp mesh a rank's backward gives its own share of
the gradient of the one global loss (the losses' ppermutes carry the
cotangents between ranks, parallel/collectives.py), so before the dp mean
the shares are added over the second axis (`sum_axis_shares`): under sp
every leaf's (each is replicated), under pp those of the leaves not split
over pp (the embed and head, which only the first and the last stage
reach); a stacked layer's gradient is its stage's own. The norm then
counts each stacked layer and each replicated leaf once.

The tensor-parallel forward's collectives are the losses' (the `mesh=`
of the loss adapters; parallel/tensor.py). The loss functions draw their
random numbers for the global batch and keep the rows of the rank's dp
index, so a dp x tp, dp x pp or dp x sp step, with or without FSDP, is the
one-device step on the global batch."""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from covomix_tpu_torch.parallel import pipeline as PP
from covomix_tpu_torch.parallel.mesh import (Mesh, all_gather, gather_params, is_sharded, param_shardings,
                                             reduce_scatter, replicate, shard_leaf, shard_params, tp_groups)
from covomix_tpu_torch.train import loop
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves, tree_map

GRAD_SYNCS = 0         # gradient collectives launched (a flat bucket each, and the sharded norm's scalar)
GRAD_SYNC_BYTES = 0    # the bytes they carried
PARAM_GATHERS = 0      # FSDP's parameter all-gathers (one bucket a step)
PARAM_GATHER_BYTES = 0


def _count_sync(t: torch.Tensor) -> None:
    global GRAD_SYNCS, GRAD_SYNC_BYTES
    GRAD_SYNCS += 1
    GRAD_SYNC_BYTES += t.numel() * t.element_size()


@torch.no_grad()
def sync_grads(mesh: Mesh, grads, *scalars) -> list:
    """The mean over the dp ranks of every gradient (in place) and of the
    0-dim `scalars` (returned): one all-reduce of one flat bucket. Without a
    collective on the dp axis, the scalars as they are."""
    if not mesh.syncs_dp:
        return list(scalars)
    dtype = grads[0].dtype if grads else torch.float32
    flat = torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1).to(dtype) for s in scalars])
    dist.all_reduce(flat, group=mesh.dp_group)
    _count_sync(flat)
    flat.div_(mesh.dp)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
    return list(flat[offset:].unbind())


def _dp_axes(specs) -> list:
    """The dp axis of each leaf (None: not split over dp)."""
    return [spec.index("dp") if "dp" in spec else None for spec in specs]


@torch.no_grad()
def gather_dp(mesh: Mesh, specs, params):
    """The tree the loss reads under FSDP: every leaf split over dp
    all-gathered (one bucket) as a new leaf that requires grad, the others
    the state's own leaves."""
    global PARAM_GATHERS, PARAM_GATHER_BYTES
    leaves, axes = tree_leaves(params), _dp_axes(specs)
    split = [i for i, ax in enumerate(axes) if ax is not None]
    out = list(leaves)
    if split and mesh.syncs_dp:
        parts = [leaves[i].detach().movedim(axes[i], 0).reshape(-1) for i in split]
        full = all_gather(torch.cat(parts)[None], 0, mesh.dp_group, mesh.dp, mesh.dp_rank)   # [dp, total]
        PARAM_GATHERS += 1
        PARAM_GATHER_BYTES += full.numel() * full.element_size()
        offset = 0
        for i in split:
            moved = leaves[i].movedim(axes[i], 0)
            n = moved.numel()
            rows = full[:, offset: offset + n].reshape((mesh.dp * moved.shape[0],) + tuple(moved.shape[1:]))
            out[i] = rows.movedim(0, axes[i]).contiguous().requires_grad_(True)
            offset += n
    it = iter(out)
    return tree_map(lambda _: next(it), params)


@torch.no_grad()
def sum_axis_shares(mesh: Mesh, specs, grads) -> None:
    """The pp or sp ranks' shares of each gradient added, in place (one
    all-reduce of one flat bucket over the axis): under sp every leaf's,
    under pp the leaves' not split over pp. Nothing on other meshes."""
    if mesh.sp > 1:
        shared = list(grads)
    elif mesh.pp > 1:
        shared = [g for g, s in zip(grads, specs) if "pp" not in s]
    else:
        return
    if not (mesh.collective and shared):
        return
    flat = torch.cat([g.reshape(-1) for g in shared])
    dist.all_reduce(flat, group=mesh.group)
    _count_sync(flat)
    offset = 0
    for g in shared:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def sync_sharded_grads(mesh: Mesh, specs, grads, params, loss):
    """The mean over the dp ranks of the gradients `grads` (of the tree the
    loss read) onto `params`' leaves, and of the loss (returned), after the
    pp / sp shares are added (`sum_axis_shares`): the leaves not split over
    dp by `sync_grads` (in place: they are the state's own), the others
    reduce-scattered (one bucket) into their shard's .grad."""
    sum_axis_shares(mesh, specs, grads)
    leaves, axes = tree_leaves(params), _dp_axes(specs)
    whole = [g for g, ax in zip(grads, axes) if ax is None]
    loss = sync_grads(mesh, whole, loss)[0]
    split = [i for i, ax in enumerate(axes) if ax is not None]
    if split and mesh.syncs_dp:
        bucket = torch.cat([grads[i].movedim(axes[i], 0).reshape(mesh.dp, -1) for i in split], dim=1)
        mine = reduce_scatter(bucket, 0, mesh.dp_group, mesh.dp, mesh.dp_rank).reshape(-1) / mesh.dp
        _count_sync(bucket)
        offset = 0
        for i in split:
            moved = leaves[i].movedim(axes[i], 0)
            n = moved.numel()
            leaves[i].grad = mine[offset: offset + n].view(moved.shape).movedim(0, axes[i]).contiguous()
            offset += n
    return loss


def sharded_norm(mesh: Mesh, specs, grads) -> torch.Tensor:
    """optax.global_norm of the whole gradient tree from the shards: each
    rank sums the squares of the leaves it holds a distinct part of (on
    each axis: split over it, or the axis' rank 0; sp splits no leaf), one
    all-reduce over the world adds them."""
    if not mesh.collective or not any(is_sharded(s) for s in specs):
        return loop.global_norm(grads)
    index = {axis: mesh.axis_info(axis)[2] for axis in ("dp", mesh.axis)}
    mine = [g for g, s in zip(grads, specs) if all(axis in s or i == 0 for axis, i in index.items())]
    sq = torch.zeros(1, device=grads[0].device)
    if mine:
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in mine]).sum().reshape(1)
    dist.all_reduce(sq)
    _count_sync(sq)
    return torch.sqrt(sq[0])


def make_sharded_train_step(loss_fn: Callable, cfg: loop.TrainConfig, mesh: Mesh, specs: dict):
    """`loop.make_train_step` on this rank's parts (`specs`: the layout of
    `init_sharded_state`): step(state, batch, generator) -> {"loss": the
    global loss, "grad_norm": the norm of the whole averaged gradient}.
    `batch` holds the rows of this rank's dp index (`shard_batch`), and
    `loss_fn` draws for the global batch and runs the model on the rank's
    tp shards (the loss adapters' `mesh=`), or its pp stage, or its sp
    frames. With every leaf replicated this is the data-parallel step: one
    all-reduce (under sp two: the sp shares, then the dp mean), the norm of
    the local tree."""
    return loop.make_train_step(loss_fn, cfg, **_sharded_hooks(mesh, specs))


def _sharded_hooks(mesh: Mesh, specs: dict) -> dict:
    """The step body's hooks on this rank's parts: FSDP's gather, the
    gradient sync and the sharded norm."""
    flat = list(specs.values())
    gather = (lambda params: gather_dp(mesh, flat, params)) if any("dp" in s for s in flat) else None
    return {"gather": gather, "norm": lambda grads: sharded_norm(mesh, flat, grads),
            "grad_sync": lambda grads, loss, params: sync_sharded_grads(mesh, flat, grads, params, loss)}


def make_sharded_multi_step(loss_fn: Callable, cfg: loop.TrainConfig, mesh: Mesh, specs: dict, k: int):
    """K sharded steps per call (`loop.MultiStep` over the sharded step
    body): batch leaves [K, b, ...] or [K, A, b, ...] of this rank's rows
    (`shard_batch(..., lead=)`), metrics stacked [K]. The steps run
    uncaptured on every backend: under gloo every collective is staged
    through host memory, and the tp collectives time themselves on the host
    (parallel/tensor.py), so neither can sit in a CUDA graph; capturing the
    NCCL form waits for runs over several cards. k < 2 returns
    `make_sharded_train_step`."""
    if k < 2:
        return make_sharded_train_step(loss_fn, cfg, mesh, specs)
    return loop.MultiStep(loss_fn, cfg, k, capture=False, **_sharded_hooks(mesh, specs))


def init_sharded_state(params, cfg: loop.TrainConfig, mesh: Mesh, *, tp: bool = True, fsdp: bool = False):
    """Rank 0's parameters on every rank (one broadcast), this rank's part of
    each (`param_shardings(mesh, params, tp=, fsdp=)`; on a pp mesh
    `params` is the pipeline's {'stacked', 'rest'} tree and the stage keeps
    its layers, `pipeline.pp_param_shardings`), then the train state
    over the parts (Adam's moments and the EMA on the same parts). Returns
    (state, specs)."""
    replicate(mesh, tree_leaves(params))
    specs = (PP.pp_param_shardings(mesh, params) if mesh.pp > 1
             else param_shardings(mesh, params, tp=tp, fsdp=fsdp))
    if any(is_sharded(s) for s in specs.values()):
        params = shard_params(mesh, params, specs)
    return loop.init_train_state(params, cfg), specs


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


_MOMENTS = ("exp_avg", "exp_avg_sq")


def gather_state(mesh: Mesh, state: loop.TrainState, specs) -> loop.TrainState:
    """The whole TrainState from every rank's parts, on every rank (a
    collective: every rank calls it): parameters, EMA and Adam's moments in
    the full layout, the counters, under an optimizer of the same settings
    over the full leaves. What rank 0 checkpoints and evaluates."""
    params = gather_params(mesh, state.params, specs)
    ema = gather_params(mesh, state.ema_params, specs)
    opt = torch.optim.Adam(tree_leaves(params), **state.optimizer.defaults)
    for (path, p), full in zip(named_leaves(state.params), tree_leaves(params)):
        st = state.optimizer.state.get(p)
        if st:
            opt.state[full] = {"step": st["step"].clone(),
                               **{k: gather_params(mesh, {path: st[k]}, specs)[path] for k in _MOMENTS}}
    return loop.TrainState(params, opt, ema, state.ema_num_updates, state.step)


@torch.no_grad()
def load_shards(mesh: Mesh, state: loop.TrainState, full: loop.TrainState, specs) -> None:
    """This rank's parts of a whole TrainState into `state`, in place."""
    for (path, p), e, fp, fe in zip(named_leaves(state.params), tree_leaves(state.ema_params),
                                    tree_leaves(full.params), tree_leaves(full.ema_params)):
        spec, groups = specs[path], tp_groups(path)
        p.copy_(shard_leaf(mesh, fp, spec, groups))
        e.copy_(shard_leaf(mesh, fe, spec, groups))
        st = full.optimizer.state.get(fp)
        state.optimizer.state.pop(p, None)
        if st:
            state.optimizer.state[p] = {"step": st["step"].clone(),
                                        **{k: shard_leaf(mesh, st[k], spec, groups) for k in _MOMENTS}}
    state.ema_num_updates, state.step = full.ema_num_updates, full.step


def shard_batch(mesh: Mesh, batch: dict, accum: bool = False, lead: int = 0) -> dict:
    """This rank's rows of a global host batch by its dp index: axis `lead`,
    the count of leading axes before the batch axis (grad accumulation's [A,
    B, ...]: 1, or `accum`; a multi-step's [K, B, ...]: 1, [K, A, B, ...]:
    2), as JAX's `lead=`. The global batch must divide by dp."""
    axis = max(lead, 1 if accum else 0)
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        if n % mesh.dp:
            raise ValueError(f"batch {k!r} of {n} rows does not divide by dp={mesh.dp}")
        index = [slice(None)] * v.ndim
        index[axis] = mesh.rows(n // mesh.dp)
        out[k] = v[tuple(index)]
    return out
