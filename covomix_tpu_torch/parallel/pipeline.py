"""Pipeline parallelism (the GPipe schedule) for the acoustic transformer:
port of covomix_tpu/parallel/pipeline.py.

The layers live stacked on a leading [depth] axis split over the mesh's pp
axis (`stack_layer_params`; `pp_param_shardings` gives ("pp", None, ...)
for each stacked leaf), and each pp rank runs the same program on its
depth / pp layers, one process per device (parallel/mesh.py). Activations
move between stages with `collectives.ppermute`, whose backward is the
reverse ring, so autograd gives the backward pipeline as JAX's transpose
does.

As in JAX:
  * the U-Net skips cross the stage boundary: each microbatch carries a
    [depth/2, B_m, T, D] skip buffer round the ring; a first-half layer g
    pushes its input into slot g, a second-half layer g pops slot
    depth-1-g. Both branches are computed and selected with `torch.where`
    (the first-half layers' skip combiners are zero placeholders whose
    gradients come out exactly zero);
  * M + pp - 1 ticks run on every rank; ingest (rank 0) and the loss emit
    (rank pp-1) are gated with `torch.where`, so every rank builds the same
    autograd graph and the backward ppermutes run in the same order on
    every rank (a rank-dependent graph would deadlock the backward);
  * the loss of the last stage is summed over pp (`axis_sum`, identity
    backward), so only a scalar crosses back.

The carry after the last tick is not sent on (JAX's scan permutes it and
discards it): M + pp - 2 ppermutes forward and as many backward a step.
Every pp rank computes the input embedding of its dp rows (rank 0 alone
ingests it) and the head at every tick (rank pp-1 alone emits), the price
of a uniform program; skipping the bubble ticks' work is later speed work.

The rows: `pp_cfm_loss` takes this rank's dp rows (the dp x pp mesh feeds
every pp rank of a dp index the same rows, `Mesh.rows`), split into M
microbatches of B / dp / M rows; its value is the mean loss of those rows,
so the mean over the dp ranks is the global loss, as for `cfm_loss`."""

from __future__ import annotations

from typing import Any, Optional

import torch

from covomix_tpu_torch.models import acoustic as A, layers as L
from covomix_tpu_torch.parallel.collectives import axis_sum, ppermute
from covomix_tpu_torch.parallel.mesh import Mesh, make_mesh
from covomix_tpu_torch.util.misc import named_leaves, tree_map


def make_pp_mesh(dp: int, pp: int, device="cuda", devices=None) -> Mesh:
    """JAX's make_pp_mesh: the dp x pp mesh (`mesh.make_mesh(pp=)`)."""
    return make_mesh(dp, device, devices, pp=pp)


def _stack(nodes):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return torch.stack([n.detach() for n in nodes])


def stack_layer_params(params: Any, cfg: A.AcousticConfig):
    """Split canonical acoustic params into (stacked_layers, rest): every
    layer leaf gains a leading [depth] axis; the first-half layers get
    zero-filled skip placeholders so the stacked tree is homogeneous."""
    d = cfg.dim
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        if "skip" not in lp:
            ref = lp["qkv"]["w"]
            lp["skip"] = {"w": torch.zeros((2 * d, d), dtype=torch.float32, device=ref.device),
                          "b": torch.zeros((d,), dtype=torch.float32, device=ref.device)}
        layers.append(lp)
    rest = {k: v for k, v in params.items() if k != "layers"}
    return _stack(layers), rest


def unstack_layer_params(stacked: Any, rest: Any, cfg: A.AcousticConfig):
    """Inverse of stack_layer_params (the first-half skips dropped), for
    checkpoint interchange with the sequential model."""
    half = cfg.depth // 2
    layers = []
    for i in range(cfg.depth):
        lp = tree_map(lambda a: a[i], stacked)
        if i < half:
            lp.pop("skip")
        layers.append(lp)
    return {**rest, "layers": layers}


def pp_param_shardings(mesh: Mesh, pp_params: Any) -> dict:
    """{path: spec} of the {'stacked', 'rest'} tree on a pp mesh: stacked
    layer leaves ("pp", None, ...), everything else replicated."""
    if mesh.pp < 2:
        raise ValueError(f"pp_param_shardings needs a pp axis of more than one rank, not pp={mesh.pp}")
    return {path: ("pp",) + (None,) * (len(leaf.shape) - 1) if path.startswith("stacked/")
            else (None,) * len(leaf.shape) for path, leaf in named_leaves(pp_params)}


def pp_cfm_loss(pp_params: Any, cfg: A.AcousticConfig, gen: Optional[torch.Generator], x1, phoneme_ids, cond,
                mask=None, *, mesh: Mesh, num_microbatches: int, cond_drop_prob: float = 0.0, sigma: float = 0.0,
                dtype=torch.float32, inputs=None):
    """OT-CFM loss (== acoustic.cfm_loss for the same draws) with the
    transformer stack pipelined over the mesh's pp axis. `pp_params`:
    {'stacked': this rank's [depth / pp, ...] layers, 'rest': the embed
    and head}; x1 / phoneme_ids / cond / mask: this rank's dp rows.
    `inputs`: the tuple of `acoustic.cfm_inputs` drawn beforehand (for
    these rows; then `gen` is not used)."""
    stacked, rest = pp_params["stacked"], pp_params["rest"]
    pp, depth, half = mesh.pp, cfg.depth, cfg.depth // 2
    if depth % pp:
        raise ValueError(f"depth {depth} not divisible by pp {pp}")
    lpp = depth // pp
    b, t, _ = x1.shape
    m = num_microbatches
    if b % m:
        raise ValueError(f"{b} rows a dp rank not divisible by {m} microbatches (the global batch must divide by "
                         f"microbatches x dp = {m * mesh.dp})")
    bm = b // m
    if inputs is None:
        inputs = A.cfm_inputs(cfg, gen, x1, cond, mask, cond_drop_prob=cond_drop_prob, sigma=sigma, mesh=mesh)
    w, times, flow, mask, cond_m, drop = inputs
    h, temb = A.embed_inputs(rest, cfg, w, phoneme_ids, cond_m, times, cond_drop_mask=drop, dtype=dtype)
    h_m = h.reshape(m, bm, t, cfg.dim)
    temb_m = temb.reshape(m, bm, cfg.time_hidden_dim)
    flow_m = flow.reshape(m, bm, t, cfg.mel_dim)
    mask_m = mask.reshape(m, bm, t)

    rank, dev = mesh.pp_rank, h.device
    flag = {v: torch.tensor(v, device=dev) for v in (False, True)}
    layers = [tree_map(lambda a, j=j: a[j], stacked) for j in range(lpp)]

    def stage(x, skip_buf, te):
        for j, lp in enumerate(layers):
            g = rank * lpp + j                              # global layer index
            first_half = flag[g < half]
            popped = skip_buf[min(max(depth - 1 - g, 0), half - 1)]
            x_in = torch.where(first_half, x, L.linear(lp["skip"], torch.cat([x, popped], dim=-1)))
            push = min(g, half - 1)
            pushed = torch.where(first_half, x, skip_buf[push])
            skip_buf = torch.cat([skip_buf[:push], pushed[None], skip_buf[push + 1:]])
            x = A.layer_core(lp, cfg, x_in, te)
        return x, skip_buf

    x = torch.zeros((bm, t, cfg.dim), dtype=dtype, device=dev)
    skip_buf = torch.zeros((half, bm, t, cfg.dim), dtype=dtype, device=dev)
    te = torch.zeros((bm, cfg.time_hidden_dim), dtype=dtype, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    ticks = m + pp - 1
    for tk in range(ticks):
        ingest = flag[rank == 0 and tk < m]
        mb_in = min(tk, m - 1)
        x = torch.where(ingest, h_m[mb_in].to(dtype), x)
        te = torch.where(ingest, temb_m[mb_in].to(dtype), te)
        x, skip_buf = stage(x, skip_buf, te)
        emit = flag[rank == pp - 1 and tk >= pp - 1]
        mb_out = min(max(tk - (pp - 1), 0), m - 1)
        pred = L.linear(rest["to_pred"], L.rmsnorm(rest["final_norm"], x)).float()
        mse = A.masked_mse(pred, flow_m[mb_out], mask_m[mb_out])
        loss = loss + torch.where(emit, mse, torch.zeros_like(mse))
        if tk < ticks - 1:
            x, skip_buf, te = ppermute(mesh, "pp", [x, skip_buf, te])
    return axis_sum(mesh, "pp", loss) / b


def ppermutes_per_step(num_microbatches: int, pp: int) -> int:
    """The ppermutes of one pp_cfm_loss forward and backward: one a tick
    but the last, each way."""
    return 2 * (num_microbatches + pp - 2)
