"""Collectives over a mesh's pp or sp axis as autograd functions: the port's
`lax.ppermute` and `lax.psum` of covomix_tpu/parallel/pipeline.py and
ring.py.

  * `ppermute(mesh, axis, tensors, shift)`: every rank of the axis sends
    its tensors to the rank `shift` places on ((i + shift) % n) and
    receives those of the rank `shift` places back, as one flat buffer.
    Its backward is the inverse permutation (the cotangents go back by
    -shift): the backward pipeline of the GPipe schedule and the reverse
    ring of ring attention, as JAX's transpose of ppermute gives them.
  * `axis_sum(mesh, axis, x)`: the sum over the axis forward, the identity
    backward (the loss psums): each rank's backward then gives its own
    share of the gradient of the summed loss, and the shares add up over
    the axis in the train step (parallel/train_step.py).

The form is chosen by the group's backend name: NCCL's batched isend /
irecv on the device buffer; under gloo, whose send and recv hand the
tensor's raw pointer to the TCP transport (host memory only), the same on
a host copy, moved back to the device after. Every rank of the axis must
make the same calls in the same order, forward and backward: the models
here build the same autograd graph on every rank for that reason.

The T2S alignment regularizer's batch gather (the JAX package's
parallel/collectives.py):

  * `all_gather_batch(x, mesh, axis)`: the concatenation of the axis'
    batches along dim 0, in rank order; its backward is JAX's transpose of
    a tiled all_gather, a reduce-scatter of the cotangent (each rank gets
    the sum over the ranks of its own rows' slice);
  * `alignment_regularizer`: pool source and target over time (logsumexp
    or max), l2-normalize, and match the off-diagonal similarity
    structures across the (gathered) batch with MSE.

Counters, in plain numbers: `PPERMUTES` launched (forward and backward
each count), `PPERMUTE_BYTES` received, `PPERMUTE_SECONDS` of host time
inside them (they return when the data is on the device); `AXIS_SUMS`."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from covomix_tpu_torch.parallel.mesh import all_gather, backend, reduce_scatter

PPERMUTES = 0
PPERMUTE_BYTES = 0
PPERMUTE_SECONDS = 0.0
AXIS_SUMS = 0


def _exchange(mesh, axis: str, tensors, shift: int) -> list:
    """The tensors of the rank `shift` places back on the axis (one flat
    buffer of the tensors' common dtype each way)."""
    global PPERMUTES, PPERMUTE_BYTES, PPERMUTE_SECONDS
    t0 = time.perf_counter()
    group, n, i = mesh.axis_info(axis)
    base = mesh.dp_rank * n               # global rank of this dp row's axis index 0
    dst, src = base + (i + shift) % n, base + (i - shift) % n
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = flat if backend(group) == "nccl" else flat.cpu()
    out = torch.empty_like(staged)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, staged, dst, group),
                                       dist.P2POp(dist.irecv, out, src, group)]):
        req.wait()
    out = out.to(flat.device)
    PPERMUTES += 1
    PPERMUTE_BYTES += out.numel() * out.element_size()
    PPERMUTE_SECONDS += time.perf_counter() - t0
    parts, offset = [], 0
    for t in tensors:
        parts.append(out[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()
    return parts


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.args = (mesh, axis, shift)
        return tuple(_exchange(mesh, axis, tensors, shift))

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, shift = ctx.args
        return (None, None, None, *_exchange(mesh, axis, grads, -shift))


def ppermute(mesh, axis: str, tensors, shift: int = 1) -> list:
    """JAX's ppermute with perm [(i, (i + shift) % n)] over the mesh's
    `axis`, of every tensor in `tensors` (one dtype) at once; differentiable."""
    if mesh.axis_info(axis)[1] == 1:
        return list(tensors)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"ppermute of tensors of one dtype, not {dtypes}")
    return list(_PPermute.apply(mesh, axis, shift, *tensors))


def _all_reduce(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    global AXIS_SUMS
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.axis_info(axis)[0])
    AXIS_SUMS += 1
    return y


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def axis_sum(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """psum over the mesh's `axis` (an f32 tensor) with an identity backward."""
    if mesh.axis_info(axis)[1] == 1:
        return x
    return _AxisSum.apply(x, mesh, axis)


@torch.no_grad()
def axis_gather(mesh, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The concatenation along `dim` of the axis' tensors, in axis order
    (no gradient)."""
    group, n, i = mesh.axis_info(axis)
    return all_gather(x.contiguous(), dim % x.dim(), group, n, i)


class _AllGatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        group, n, i = mesh.axis_info(axis)
        return all_gather(x.contiguous(), 0, group, n, i)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        group, n, i = mesh.axis_info(axis)
        return reduce_scatter(g.contiguous(), 0, group, n, i), None, None


def all_gather_batch(x: torch.Tensor, mesh=None, axis: str = "dp") -> torch.Tensor:
    """The axis' batches concatenated along dim 0 (every rank's of the same
    shape); differentiable, each rank's gradient the sum over the ranks of
    its rows' slice. Without a mesh, or on an axis of one rank, `x`."""
    if mesh is None or mesh.axis_info(axis)[1] == 1:
        return x
    return _AllGatherBatch.apply(x, mesh, axis)


def alignment_regularizer(source_emb: torch.Tensor, target_emb: torch.Tensor, source_mask=None, target_mask=None, *,
                          mesh=None, axis: str = "dp", use_logsumexp_pool: bool = True,
                          temp: float = 0.1) -> torch.Tensor:
    """SpeechAlign-style CFG regularizer: source [B, S, D] and target [B, T,
    D] embeddings, masked positions filled with -1e30 (finite under /temp,
    so an all-masked row pools to a constant vector instead of nan), with
    `mesh` gathered over `axis`, pooled over time (logsumexp at `temp`, or
    the max), l2-normalized (norm floor 1e-12); the mean over the
    off-diagonal pairs of the squared difference of the two cosine
    similarity matrices."""
    neg = torch.tensor(-1e30, dtype=source_emb.dtype, device=source_emb.device)
    if source_mask is not None:
        source_emb = torch.where(source_mask[..., None], source_emb, neg)
    if target_mask is not None:
        target_emb = torch.where(target_mask[..., None], target_emb, neg.to(target_emb.dtype))
    source_emb = all_gather_batch(source_emb, mesh, axis)
    target_emb = all_gather_batch(target_emb, mesh, axis)
    if use_logsumexp_pool:
        source_pool = torch.logsumexp(source_emb / temp, dim=1) * temp
        target_pool = torch.logsumexp(target_emb / temp, dim=1) * temp
    else:   # amax: the gradient of tied maxima split evenly, as jnp.max's
        source_pool = torch.amax(source_emb, dim=1)
        target_pool = torch.amax(target_emb, dim=1)

    def l2norm(t):
        return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)

    s, t = l2norm(source_pool), l2norm(target_pool)
    sim_s, sim_t = s @ s.T, t @ t.T
    b = sim_s.shape[0]
    off_diag = ~torch.eye(b, dtype=torch.bool, device=sim_s.device)
    diff = torch.where(off_diag, sim_s - sim_t, torch.zeros_like(sim_s))
    return torch.sum(torch.square(diff)) / max(b * b - b, 1)
