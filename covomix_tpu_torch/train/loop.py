"""Training loop (port of covomix_tpu/train/loop.py): Adam + EMA + the
reference warmup/decay LR schedule, eagerly in PyTorch.

  * Adam, betas (0.9, 0.999), eps 1e-8 (optax's defaults): torch's
    bias-corrected denominator and optax's m_hat / (sqrt(v_hat) + eps) are
    the same function. The learning rate of an update is the schedule at the
    step count before it, as in optax (step 0 uses schedule(0)).
  * `grad_clip` clips the global norm before Adam (optax
    clip_by_global_norm); the reported grad_norm is the norm before clipping.
  * EMA with torch_ema's ramp: decay min(d, (1+n)/(10+n)) with n the
    post-increment update count; updated after every optimizer step.
  * gradient accumulation: `grad_accum` micro-batches per step (batch leaves
    carry a leading [A, ...] axis), loss and gradients the mean over them,
    one micro-batch's activations live at a time.

State is updated in place (parameters, Adam moments, EMA); JAX's jitted step
returns a new state instead. `make_multi_step` (K steps in one jitted
dispatch) has no eager counterpart and is not ported."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from covomix_tpu_torch.util.misc import tree_leaves, tree_map


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-4
    ema_decay: float = 0.999
    use_lr_schedule: bool = False
    total_epochs: int = 500
    wake_up_epochs: int = 15
    decay_start_epoch: int = 30
    steps_per_epoch: int = 1000
    grad_clip: Optional[float] = None
    grad_accum: int = 1


@dataclasses.dataclass
class TrainState:
    params: Any                     # tree of f32 leaf tensors that require grad
    optimizer: torch.optim.Adam     # over tree_leaves(params)
    ema_params: Any                 # tree of f32 tensors, same names
    ema_num_updates: int = 0
    step: int = 0


def reference_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Epoch-granular schedule: linear warm-up over `wake_up_epochs`, flat
    until `decay_start_epoch`, linear decay to 0 at `total_epochs`."""

    def schedule(step: int) -> float:
        epoch = step // cfg.steps_per_epoch
        if epoch < cfg.wake_up_epochs:
            lr = cfg.lr * (epoch + 1) / cfg.wake_up_epochs
        elif epoch < cfg.decay_start_epoch:
            lr = cfg.lr
        else:
            lr = cfg.lr * (1 - (epoch - cfg.decay_start_epoch) / (cfg.total_epochs - cfg.decay_start_epoch))
        return max(lr, 0.0)

    return schedule


def init_train_state(params, cfg: TrainConfig) -> TrainState:
    """Take `params` (a tree of f32 tensors) as the trained leaves; the EMA
    starts as a copy."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = torch.optim.Adam(tree_leaves(params), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    ema = tree_map(lambda p: p.detach().clone(), params)
    return TrainState(params, opt, ema)


@torch.no_grad()
def ema_update(ema_params, params, num_updates: int, decay: float) -> None:
    """torch_ema's update, in place: n = num_updates + 1 (the count after
    this update), d = min(decay, (1+n)/(10+n)), shadow -= (1-d)(shadow -
    param); d in f32 as the JAX package computes it (first update 2/11)."""
    n = np.float32(num_updates) + np.float32(1)
    d = min(np.float32(decay), (np.float32(1) + n) / (np.float32(10) + n))
    w = float(np.float32(1) - d)
    for e, p in zip(tree_leaves(ema_params), tree_leaves(params)):
        e.sub_((e - p) * w)


def global_norm(tensors):
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(t.float())) for t in tensors]).sum())


def to_device(batch, device):
    """A batch dict of numpy arrays (or tensors) -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def accumulated_value_and_grad(loss_fn: Callable, grad_accum: int):
    """Returns run(params, batch, generator) -> (loss, grads): backward of
    loss_fn into the leaves' .grad, over `grad_accum` micro-batches (batch
    leaves [A, b, ...]) when above 1, loss and gradients then the mean over
    them. grads is aligned with tree_leaves(params); a leaf the loss does
    not reach gets zeros."""

    def run(params, batch, generator):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        if grad_accum <= 1:
            loss = loss_fn(params, batch, generator)
            loss.backward()
            loss = loss.detach()
        else:
            loss = 0.0
            for i in range(grad_accum):
                part = loss_fn(params, {k: v[i] for k, v in batch.items()}, generator)
                part.backward()
                loss = loss + part.detach().float()
            inv = 1.0 / grad_accum
            loss = loss * inv
            for p in leaves:
                if p.grad is not None:
                    p.grad.mul_(inv)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss, [p.grad for p in leaves]

    return run


def make_train_step(loss_fn: Callable, cfg: TrainConfig, grad_sync: Optional[Callable] = None,
                    gather: Optional[Callable] = None, norm: Callable = global_norm,
                    post_update: Optional[Callable] = None, schedule_count: Callable = lambda state: state.step):
    """loss_fn(params, batch, generator) -> scalar loss tensor. Returns
    step(state, batch, generator) -> {"loss", "grad_norm"} (0-dim tensors on
    the parameters' device), updating `state` in place: gradients, global
    norm, clipping, Adam at the schedule's learning rate, EMA, counters.
    The hooks of the sharded step (parallel/train_step.py): `gather(params)
    -> tree`, what the loss reads in place of state.params (FSDP's
    all-gather); `grad_sync(grads, loss, params) -> loss`, between the
    backward (`grads` of the tree the loss read) and the norm, leaving the
    gradients of state.params' leaves in their .grad (the data-parallel
    mean); `norm(grads)`, the global norm of those gradients. BMUF's
    (parallel/bmuf.py): `post_update(state)`, between Adam and the EMA;
    `schedule_count(state)`, the count the schedule reads (default the step)."""
    vg = accumulated_value_and_grad(loss_fn, cfg.grad_accum)
    schedule = reference_lr_schedule(cfg) if cfg.use_lr_schedule else None

    def step(state: TrainState, batch, generator):
        leaves = tree_leaves(state.params)
        params = state.params if gather is None else gather(state.params)
        loss, grads = vg(params, to_device(batch, leaves[0].device), generator)
        if grad_sync is not None:
            loss = grad_sync(grads, loss, state.params)
            grads = [p.grad for p in leaves]
        gnorm = norm(grads)
        if cfg.grad_clip:
            keep = gnorm < cfg.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / gnorm * cfg.grad_clip))
        lr = schedule(schedule_count(state)) if schedule is not None else cfg.lr
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if post_update is not None:
            post_update(state)
        ema_update(state.ema_params, state.params, state.ema_num_updates, cfg.ema_decay)
        state.ema_num_updates += 1
        state.step += 1
        return {"loss": loss, "grad_norm": gnorm}

    return step


# ---------------------------------------------------------------------------
# per-model loss adapters


def acoustic_loss_fn(cfg_model, *, cond_drop_prob: float = 0.0, dtype=torch.float32, mesh=None,
                     num_microbatches: int = 4):
    """Batch: {'x': [B, T, D] target mel(s), 'phonemes': [B, T(, 2)], 'mask':
    [B, T] bool}. VoSingle: cond = x. VoMix ('two_one'): x holds [cond_A |
    cond_B | mixed]; target = x[..., -80:], cond = x[..., :-80]. `mesh`
    (parallel/mesh.py): the batch is this rank's rows and the draws are
    the global batch's; on a pp mesh the loss is the GPipe schedule's over
    `num_microbatches` (parallel/pipeline.py, the {'stacked', 'rest'}
    parameters), on an sp mesh the sequence-parallel one (parallel/ring.py)."""
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.parallel import pipeline, ring

    def loss(params, batch, generator):
        x = batch["x"]
        if cfg_model.mode == "two_one":
            target, cond = x[..., -80:], x[..., :-80]
        else:
            target, cond = x, x
        args = (params, cfg_model, generator, target, batch["phonemes"], cond, batch.get("mask"))
        if mesh is not None and mesh.pp > 1:
            return pipeline.pp_cfm_loss(*args, mesh=mesh, num_microbatches=num_microbatches,
                                        cond_drop_prob=cond_drop_prob, dtype=dtype)
        if mesh is not None and mesh.sp > 1:
            return ring.cfm_loss_sp(*args, mesh=mesh, cond_drop_prob=cond_drop_prob, dtype=dtype)
        return A.cfm_loss(*args, cond_drop_prob=cond_drop_prob, dtype=dtype, mesh=mesh)

    return loss


def t2s_loss_fn(cfg_model, dtype=torch.float32, mesh=None):
    """Batch: {'text_ids': [B, S], 'semantic_ids': [B, T(, 2)]}. The
    generator is passed on for the loss's cond_drop draw. `mesh`: the batch
    is this rank's rows; the CE is normalised by the global token count."""
    from covomix_tpu_torch.models import text2semantic as T

    def loss(params, batch, generator):
        return T.forward_loss(params, cfg_model, batch["text_ids"], batch["semantic_ids"], generator=generator,
                              dtype=dtype, mesh=mesh)

    return loss
