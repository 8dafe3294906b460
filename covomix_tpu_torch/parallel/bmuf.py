"""BMUF, blockwise model-update filtering (port of
covomix_tpu/parallel/bmuf.py): each data-parallel rank takes LOCAL optimizer
steps on its own rows with its own gradients, and every `sync_every` steps
the ranks reconcile with a momentum-filtered block update.

JAX keeps the diverging local models as one stacked [ndp, ...] tree sharded
on 'dp' and picks the branch with `lax.switch` inside one compiled step. The
port runs one process per rank (parallel/mesh.py), so each rank simply holds
its own local model, Adam moments, EMA and its own BMUF state (`global`, the
model of the last sync; `smoothed`, the filtered block gradient; `t`, the
step count), which is what a row of JAX's stacked layout stands for. The
branch is chosen on the host from `t`:

    warmup_sync  at t == warmup_steps (warmup_steps > 0): rank 0's model on
                 every rank (one broadcast), or the mean with `average_sync`;
                 global = that model, smoothed = 0;
    block_sync   at t > warmup_steps and t % sync_every == 0:
                     grad     = mean over dp of (global - local)
                     smoothed = block_momentum * smoothed + block_lr * grad
                     params   = global - smoothed
                     params  -= block_momentum * smoothed   (use_nbm: Nesterov)
                     global   = params
                 and at block_momentum 0 the plain mean of the models;
    noop         otherwise: no collective at all.

Each sync is one collective over the dp group on one flat f32 bucket of the
whole parameter tree. `make_bmuf_train_step` is the port of
`make_bmuf_train_step`: the rank's gradient with no dp sync, clipping and
Adam (its learning rate from Adam's own count, which the warmup resets, as
optax's count is), `bmuf_update`, at the warmup step Adam's state back to
its initial value, the EMA of the post-BMUF parameters; the loss and grad
norm averaged over dp for reporting only.

Counters, in plain numbers: `SYNCS` (sync collectives launched), their
`SYNC_BYTES` and `SYNC_SECONDS` of host time inside them."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from covomix_tpu_torch.parallel.mesh import Mesh, all_gather
from covomix_tpu_torch.train import loop
from covomix_tpu_torch.util.misc import tree_leaves, tree_map

SYNCS = 0
SYNC_BYTES = 0
SYNC_SECONDS = 0.0


@dataclasses.dataclass(frozen=True)
class BMUFConfig:
    sync_every: int = 50                    # global_sync_iter
    block_momentum: Optional[float] = None  # default 1 - 1/world
    block_lr: float = 1.0
    use_nbm: bool = True                    # Nesterov block momentum
    average_sync: bool = False              # warmup: average instead of rank 0's model
    warmup_steps: int = 0                   # warmup_iterations

    def resolved_momentum(self, world: int) -> float:
        return (1.0 - 1.0 / world) if self.block_momentum is None else self.block_momentum


def init_bmuf_state(params) -> dict:
    """A rank's block state: the last-synced global model (a copy of
    `params`), the smoothed block gradient (zeros) and the count t = 0."""
    return {"global": tree_map(lambda p: p.detach().clone(), params),
            "smoothed": tree_map(lambda p: torch.zeros_like(p.detach()), params), "t": 0}


def branch(t: int, cfg: BMUFConfig) -> str:
    """The branch of the step whose count, after it, is `t`."""
    if cfg.warmup_steps > 0 and t == cfg.warmup_steps:
        return "warmup_sync"
    if t > cfg.warmup_steps and t % cfg.sync_every == 0:
        return "block_sync"
    return "noop"


def _collective(mesh: Mesh, flat: torch.Tensor, op: str) -> None:
    """`op` ("mean" or "broadcast" from dp rank 0) of a flat bucket over the
    dp group, in place. One rank alone is its own mean; a mesh of several dp
    ranks without a process group raises."""
    global SYNCS, SYNC_BYTES, SYNC_SECONDS
    if mesh.dp == 1 and not mesh.collective:
        return
    if not mesh.syncs_dp:
        raise RuntimeError(f"BMUF sync over dp={mesh.dp} needs a process group (none is up)")
    t0 = time.perf_counter()
    if op == "broadcast":
        dist.broadcast(flat, src=mesh.rank % mesh.n, group=mesh.dp_group)
    else:
        dist.all_reduce(flat, group=mesh.dp_group)
        flat.div_(mesh.dp)
    SYNCS += 1
    SYNC_BYTES += flat.numel() * flat.element_size()
    SYNC_SECONDS += time.perf_counter() - t0


def _flat(leaves) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in leaves])


def _scatter(flat: torch.Tensor, *trees) -> None:
    """Copy the flat bucket into the leaves of every tree in `trees`."""
    for tree in trees:
        offset = 0
        for t in tree_leaves(tree):
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def bmuf_update(params, state: dict, cfg: BMUFConfig, mesh: Mesh) -> str:
    """One BMUF tick after the local optimizer update, in place on `params`
    and `state` (a rank's `init_bmuf_state`); returns the branch taken. The
    collectives run over the dp group of `mesh`, on sync steps only."""
    bm = cfg.resolved_momentum(mesh.dp)
    state["t"] += 1
    kind = branch(state["t"], cfg)
    if kind == "noop":
        return kind
    if kind == "warmup_sync":
        new = _flat(tree_leaves(params))
        _collective(mesh, new, "mean" if cfg.average_sync else "broadcast")
        _scatter(new, params, state["global"])
        for m in tree_leaves(state["smoothed"]):
            m.zero_()
        return kind
    if bm == 0.0:       # plain parameter averaging
        new = _flat(tree_leaves(params))
        _collective(mesh, new, "mean")
        _scatter(new, params, state["global"])
        return kind
    grad = _flat(tree_leaves(state["global"])) - _flat(tree_leaves(params))
    _collective(mesh, grad, "mean")
    smoothed = _flat(tree_leaves(state["smoothed"])) * bm + grad * cfg.block_lr
    new = _flat(tree_leaves(state["global"])) - smoothed
    if cfg.use_nbm:
        new = new - smoothed * bm
    _scatter(smoothed, state["smoothed"])
    _scatter(new, params, state["global"])
    return kind


def rank_generator(device, seed: int, dp_rank: int) -> torch.Generator:
    """The generator of a BMUF rank's training draws: its own stream, seeded
    from (seed, dp index), as JAX folds the dp index into the step's key."""
    seed = int(np.random.SeedSequence([seed, dp_rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def make_bmuf_train_step(loss_fn: Callable, cfg: loop.TrainConfig, bmuf_cfg: BMUFConfig, mesh: Mesh,
                         bmuf_state: dict):
    """step(state, batch, generator) -> {"loss", "grad_norm"}, in place on
    `state` and the rank's `bmuf_state` (`init_bmuf_state`):
    `loop.make_train_step` on the rank's rows with no gradient sync
    (`loss_fn` is the plain loss, without the dp mesh), the learning rate at
    Adam's count, then `bmuf_update`, at the warmup step Adam's state reset
    (moments and count, so the schedule restarts as optax's does), then the
    EMA of the post-BMUF parameters. The metrics are the means over dp of
    the ranks' loss and grad norm (one all-reduce of two scalars, for
    reporting; no gradient is averaged)."""
    from covomix_tpu_torch.train.gan import opt_count

    def post_update(state):
        if bmuf_update(state.params, bmuf_state, bmuf_cfg, mesh) == "warmup_sync":
            state.optimizer.state.clear()

    inner = loop.make_train_step(loss_fn, cfg, post_update=post_update,
                                 schedule_count=lambda state: opt_count(state.optimizer))

    def step(state: loop.TrainState, batch, generator):
        m = inner(state, batch, generator)
        pair = torch.stack([m["loss"].float(), m["grad_norm"].float()])
        if mesh.syncs_dp:
            dist.all_reduce(pair, group=mesh.dp_group)
            pair = pair / mesh.dp
        return {"loss": pair[0], "grad_norm": pair[1]}

    return step


# ---------------------------------------------------------------------------
# checkpoints: every rank's state in JAX's stacked layout


@torch.no_grad()
def stack_states(mesh: Mesh, state: loop.TrainState, bmuf_state: dict):
    """Every rank's train and BMUF state gathered over dp into JAX's stacked
    layout (a leading [dp] axis on every array, counters included), as
    `checkpoint.io.StackedTrainState` on every rank: one all-gather of one
    flat bucket per dtype, on the rank's device. A collective: every rank
    calls it."""
    from covomix_tpu_torch.checkpoint.io import StackedTrainState, bmuf_rank_arrays

    row = bmuf_rank_arrays(state, bmuf_state)
    out = {}
    for dtype in sorted({a.dtype for a in row.values()}, key=str):
        names = [k for k, a in row.items() if a.dtype == dtype]
        bucket = torch.from_numpy(np.concatenate([row[k].reshape(-1) for k in names])).to(mesh.device)[None]
        full = all_gather(bucket, 0, mesh.dp_group, mesh.dp, mesh.dp_rank) if mesh.syncs_dp else bucket
        full = full.cpu().numpy()
        offset = 0
        for k in names:
            n = row[k].size
            out[k] = full[:, offset: offset + n].reshape((full.shape[0],) + row[k].shape)
            offset += n
    return StackedTrainState({k: out[k] for k in row})
