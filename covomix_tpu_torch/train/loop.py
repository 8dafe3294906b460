"""Training loop (port of covomix_tpu/train/loop.py): Adam + EMA + the
reference warmup/decay LR schedule, in PyTorch.

  * Adam, betas (0.9, 0.999), eps 1e-8 (optax's defaults): torch's
    bias-corrected denominator and optax's m_hat / (sqrt(v_hat) + eps) are
    the same function. The learning rate of an update is the schedule at the
    step count before it, as in optax (step 0 uses schedule(0)). On CUDA
    the optimizer is torch's fused Adam (`fused=True, capturable=True`):
    one multi-tensor kernel updates every leaf, its step count lives on the
    device and it reads the learning rate from a 0-dim device tensor, so a
    step reads nothing back on the host and can be captured into a CUDA
    graph. (The foreach form with `capturable=True` runs three of its ops
    leaf by leaf: 3.1-3.6 ms more a full-width step on an H100.) On the CPU
    it is the plain Adam, given floats.
  * `grad_clip` clips the global norm before Adam (optax
    clip_by_global_norm); the reported grad_norm is the norm before clipping.
  * EMA with torch_ema's ramp: decay min(d, (1+n)/(10+n)) with n the
    post-increment update count; updated after every optimizer step.
  * gradient accumulation: `grad_accum` micro-batches per step (batch leaves
    carry a leading [A, ...] axis), loss and gradients the mean over them,
    one micro-batch's activations live at a time.
  * `make_multi_step`: K optimizer steps per call over a stacked [K, ...]
    batch (JAX unrolls them into one jitted dispatch). On CUDA the K steps
    are captured once per batch shape as one CUDA graph and replayed, the
    learning rates and EMA weights of the K steps handed in as device
    buffers; on the CPU they run directly. Either way the result is that of
    K `make_train_step` calls on the slices, the caller's generator
    included.

State is updated in place (parameters, Adam moments, EMA); JAX's jitted step
returns a new state instead."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from covomix_tpu_torch.util import profiling
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves, tree_map


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
    starts as a copy. Adam is fused and capturable on CUDA (module
    docstring)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                           **({"fused": True, "capturable": True} if leaves[0].is_cuda else {}))
    ema = tree_map(lambda p: p.detach().clone(), params)
    return TrainState(params, opt, ema)


def ema_weight(num_updates: int, decay: float) -> float:
    """1 - d of torch_ema's update number `num_updates` + 1: n = num_updates
    + 1 (the count after the update), d = min(decay, (1+n)/(10+n)), in f32 as
    the JAX package computes it (first update 1 - 2/11)."""
    n = np.float32(num_updates) + np.float32(1)
    d = min(np.float32(decay), (np.float32(1) + n) / (np.float32(10) + n))
    return float(np.float32(1) - d)


@torch.no_grad()
def ema_apply(ema_params, params, weight) -> None:
    """shadow -= weight * (shadow - param), in place; `weight` a float or a
    0-dim tensor on the parameters' device."""
    for e, p in zip(tree_leaves(ema_params), tree_leaves(params)):
        e.sub_((e - p) * weight)


def ema_update(ema_params, params, num_updates: int, decay: float) -> None:
    """torch_ema's update, in place, at `ema_weight(num_updates, decay)`."""
    ema_apply(ema_params, params, ema_weight(num_updates, decay))


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


def make_step_body(loss_fn: Callable, cfg: TrainConfig, grad_sync: Optional[Callable] = None,
                   gather: Optional[Callable] = None, norm: Callable = global_norm,
                   post_update: Optional[Callable] = None):
    """body(state, batch, generator, lr, ema_weight) -> (loss, grad_norm):
    one optimizer step on a batch already on the parameters' device, at the
    learning rate and EMA weight given (floats on the CPU, 0-dim tensors on
    CUDA: `device_scalar`), in place on `state` and without touching its
    counters: gradients, global norm, clipping, Adam, EMA. On CUDA it reads
    nothing back on the host (the hooks of the single-device step add
    nothing that does), so `MultiStep` can capture it. The hooks are
    `make_train_step`'s."""
    vg = accumulated_value_and_grad(loss_fn, cfg.grad_accum)

    def body(state: TrainState, batch, generator, lr, weight):
        leaves = tree_leaves(state.params)
        params = state.params if gather is None else gather(state.params)
        loss, grads = vg(params, batch, generator)
        if grad_sync is not None:
            loss = grad_sync(grads, loss, state.params)
            grads = [p.grad for p in leaves]
        gnorm = norm(grads)
        if cfg.grad_clip:
            keep = gnorm < cfg.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / gnorm * cfg.grad_clip))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if post_update is not None:
            post_update(state)
        ema_apply(state.ema_params, state.params, weight)
        return loss, gnorm

    return body


def device_scalar(value: float, device: torch.device):
    """A learning rate or EMA weight as the step body takes it: the float on
    the CPU, a 0-dim f32 tensor filled on the device on CUDA (a fill, no
    host-to-device copy)."""
    if device.type == "cuda":
        return torch.full((), value, dtype=torch.float32, device=device)
    return value


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
    body = make_step_body(loss_fn, cfg, grad_sync=grad_sync, gather=gather, norm=norm, post_update=post_update)
    schedule = reference_lr_schedule(cfg) if cfg.use_lr_schedule else None

    def step(state: TrainState, batch, generator):
        dev = tree_leaves(state.params)[0].device
        lr = schedule(schedule_count(state)) if schedule is not None else cfg.lr
        loss, gnorm = body(state, to_device(batch, dev), generator, device_scalar(lr, dev),
                           device_scalar(ema_weight(state.ema_num_updates, cfg.ema_decay), dev))
        state.ema_num_updates += 1
        state.step += 1
        return {"loss": loss, "grad_norm": gnorm}

    return step


# ---------------------------------------------------------------------------
# K steps per call


GRAPH_CACHE_SIZE = 4    # captured multi-steps kept per MultiStep (batch shapes), least recently used dropped


def _adam_ready(opt: torch.optim.Adam) -> None:
    """Every parameter's Adam state made now, as Adam's first step would
    make it (count 0 on the parameter's device, moments 0), so that no
    step inside a capture allocates the state from the graph's memory."""
    for group in opt.param_groups:
        for p in group["params"]:
            if not opt.state.get(p):
                opt.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=p.device),
                                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


def state_tensors(state: TrainState) -> dict:
    """{name: tensor} of every tensor a step writes in place: parameters
    ("params/<leaf>"), EMA ("ema/<leaf>"), Adam's counts and moments
    ("adam_<key>/<leaf>")."""
    out = {}
    for (name, p), (_, e) in zip(named_leaves(state.params), named_leaves(state.ema_params)):
        out[f"params/{name}"], out[f"ema/{name}"] = p, e
        for key, v in (state.optimizer.state.get(p) or {}).items():
            out[f"adam_{key}/{name}"] = v
    return out


def _slice(batch: dict, i: int) -> dict:
    return {k: v[i] for k, v in batch.items()}


class _Captured:
    """One batch shape's K steps as a CUDA graph: the static [K, ...] batch
    and the [K] learning-rate and EMA-weight buffers it reads, the stacked
    metrics it writes, the generator it draws from (registered with the
    graph; the caller's state is copied in before a replay and out after),
    the state tensors it was captured on (`bound`), and `launches`, the
    flash kernel launches of one replay ({counter name: count})."""

    def __init__(self, body, k: int, state: TrainState, batch: dict, generator, lrs, weights):
        dev = tree_leaves(state.params)[0].device
        self.k, self.state = k, state
        self.inputs = {name: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v).dtype, device=dev)
                       for name, v in batch.items()}
        self.lr = torch.zeros(k, dtype=torch.float32, device=dev)
        self.weight = torch.zeros(k, dtype=torch.float32, device=dev)
        self.generator = None if generator is None else torch.Generator(device=dev)
        self.graph, self.metrics, self.capture_s = None, None, 0.0
        self.launches = collections.Counter()
        self.bound = []
        self._capture(body, batch, lrs, weights)

    def _capture(self, body, batch, lrs, weights):
        """Warm one step up on a side stream on the real state (at the first
        dispatch's rates), put the state back as it was, then capture the K
        steps."""
        from covomix_tpu_torch.ops import flash_attention as FA

        if self.generator is not None and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state); a captured step would replay one draw")
        state, k = self.state, self.k
        _adam_ready(state.optimizer)
        self.bound = list(state_tensors(state).values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.fill(batch, lrs, weights)
        with torch.no_grad():
            kept = [t.clone() for t in self.bound]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(state, _slice(self.inputs, 0), self.generator, self.lr[0], self.weight[0])
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(self.bound, kept):
                t.copy_(v)
        del kept
        for p in tree_leaves(state.params):
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = collections.Counter(FA.KERNEL.captured)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            losses, gnorms = [], []
            for i in range(k):
                loss, gnorm = body(state, _slice(self.inputs, i), self.generator, self.lr[i], self.weight[i])
                losses.append(loss)
                gnorms.append(gnorm)
            self.metrics = (torch.stack(losses), torch.stack(gnorms))
        torch.cuda.synchronize()
        for p in tree_leaves(state.params):     # the capture's gradients live in the graph's pool
            p.grad = None
        self.launches = collections.Counter(FA.KERNEL.captured) - before
        self.graph, self.capture_s = graph, time.perf_counter() - t0

    def fill(self, batch: dict, lrs, weights) -> None:
        """The dispatch's batch and rates into the static buffers, queued on
        the stream behind the previous replay (from pageable host memory the
        copy stages the source before it returns, so nothing waits)."""
        for name, buf in self.inputs.items():
            buf.copy_(torch.as_tensor(batch[name]), non_blocking=True)
        self.lr.copy_(torch.tensor(lrs, dtype=torch.float32), non_blocking=True)
        self.weight.copy_(torch.tensor(weights, dtype=torch.float32), non_blocking=True)

    def fits(self, state: TrainState) -> bool:
        """Whether `state` still holds the very tensors the graph writes."""
        now = list(state_tensors(state).values())
        return len(now) == len(self.bound) and all(a is b for a, b in zip(now, self.bound))

    def replay(self, generator) -> dict:
        """The K steps on what `fill` (or the capture) left in the buffers."""
        if generator is not None:
            self.generator.set_state(generator.get_state())
        self.graph.replay()
        if generator is not None:
            generator.set_state(self.generator.get_state())
        return {"loss": self.metrics[0].clone(), "grad_norm": self.metrics[1].clone()}


class MultiStep:
    """step(state, batch, generator) -> {"loss": [K], "grad_norm": [K]}: K
    optimizer steps on the [K, ...] (under grad_accum [K, A, b, ...]) batch
    leaves, the learning rates at the schedule's counts step..step+K-1 and
    the EMA weights at ema_num_updates..+K-1 (what K `make_train_step`
    calls use), then the counters moved by K. On CUDA with `capture` the K
    steps are captured once per (batch shapes, dtypes) and replayed
    (`_Captured`, at most GRAPH_CACHE_SIZE kept; the generator must be on
    the parameters' device); a capture or replay failure raises. Otherwise
    they are K `make_train_step` calls on the slices. `hooks`:
    `make_step_body`'s. Counts of the
    captured path: `captures`, `replays`, and `replayed` ({flash counter
    name: launches run by replays}), beside the eager counters in
    ops/flash_attention.KERNEL, which the warm-up before a capture adds to;
    `dispatches` counts the calls on either path.
    A capture needs the parameters' gradient accumulators made inside it: a
    tensor the caller keeps that was computed from a parameter with autograd
    on (a clone without `detach`, an undetached loss) keeps the accumulator
    made on the stream of its time, and the captured backward would have to
    join that stream, which the capture refuses (it raises)."""

    def __init__(self, loss_fn: Callable, cfg: TrainConfig, k: int, capture: bool = True, **hooks):
        self.body = make_step_body(loss_fn, cfg, **hooks)
        self.single = make_train_step(loss_fn, cfg, **hooks)
        self.cfg, self.k, self.capture = cfg, k, capture
        self.schedule = reference_lr_schedule(cfg) if cfg.use_lr_schedule else None
        self.graphs: "collections.OrderedDict[tuple, _Captured]" = collections.OrderedDict()
        self.captures = self.replays = self.dispatches = 0
        self.replayed = collections.Counter()
        self.last: Optional[_Captured] = None

    def rates(self, state: TrainState):
        """([K] learning rates, [K] EMA weights) of the next K steps."""
        lrs = [self.schedule(state.step + i) if self.schedule is not None else self.cfg.lr for i in range(self.k)]
        return lrs, [ema_weight(state.ema_num_updates + i, self.cfg.ema_decay) for i in range(self.k)]

    def __call__(self, state: TrainState, batch, generator) -> dict:
        for name, v in batch.items():
            if v.shape[0] != self.k:
                raise ValueError(f"multi-step batch leaf {name!r} has {v.shape[0]} steps on its leading axis, "
                                 f"expected K={self.k}")
        self.dispatches += 1
        with profiling.scope("train.dispatch", self.dispatches):
            if tree_leaves(state.params)[0].is_cuda and self.capture:
                metrics = self._replay(state, batch, generator)
                state.step += self.k
                state.ema_num_updates += self.k
                return metrics
            out = [self.single(state, _slice(batch, i), generator) for i in range(self.k)]
            return {key: torch.stack([m[key] for m in out]) for key in ("loss", "grad_norm")}

    def _replay(self, state, batch, generator) -> dict:
        dev = tree_leaves(state.params)[0].device
        with profiling.scope("train.fill"):
            lrs, weights = self.rates(state)
            if generator is not None and generator.device.type != dev.type:
                raise ValueError(f"a captured multi-step draws on the parameters' device {dev}; the generator is "
                                 f"on {generator.device}")
            key = tuple((name, tuple(v.shape), str(v.dtype)) for name, v in sorted(batch.items()))
            entry = self.graphs.pop(key, None)
            if entry is not None and not entry.fits(state):
                entry = None        # another state, or its Adam state replaced (a load): capture again
            if entry is not None:
                entry.fill(batch, lrs, weights)
        if entry is None:
            with profiling.scope("train.capture"):     # filled with this dispatch's batch and rates
                entry = _Captured(self.body, self.k, state, batch, generator, lrs, weights)
            self.captures += 1
            while len(self.graphs) >= GRAPH_CACHE_SIZE:
                self.graphs.popitem(last=False)
        self.graphs[key] = self.last = entry
        with profiling.scope("train.replay"):
            metrics = entry.replay(generator)
        self.replays += 1
        self.replayed.update(entry.launches)
        return metrics


def make_multi_step(loss_fn: Callable, cfg: TrainConfig, k: int):
    """K optimizer steps per call (`MultiStep`), the JAX package's contract:
    batch leaves [K, ...] (or [K, A, b, ...] under grad_accum), metrics
    stacked [K], the result that of K `make_train_step` calls on the slices
    of the same stacked batch. k < 2 returns `make_train_step`."""
    if k < 2:
        return make_train_step(loss_fn, cfg)
    return MultiStep(loss_fn, cfg, k)


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
