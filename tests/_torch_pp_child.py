"""The rank processes of the port's pipeline- and sequence-parallel tests
(tests/test_torch_pp.py, tests/test_torch_sp.py).

`covomix_tpu_torch.parallel.multihost.spawn` starts them over gloo on the
CPU. Each reads the parent's cases from `<dir>/inputs.pkl` (numpy trees,
config dicts and JAX's draws), runs each on its dp x pp or dp x sp mesh
(every rank builds the meshes in the same order) and writes its results
to `<dir>/rank<r>.pkl`. Nothing here imports jax: the ranks are the port
alone, and the parent holds them against the JAX package."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.parallel import collectives as C, mesh as M, pipeline as PP, ring as R, train_step as TS
from covomix_tpu_torch.train import loop
from covomix_tpu_torch.util.misc import named_leaves

TIMEOUT_S = 120.0     # a collective out of step fails the test instead of hanging the suite


def _numpy_leaves(tree) -> dict:
    return {n: t.detach().float().numpy().copy() for n, t in named_leaves(tree)}


def _tensors(arrays):
    return tuple(None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays)


def _rows(mesh, arrays, n):
    """This rank's dp rows of global arrays of n rows."""
    return tuple(None if a is None else a[mesh.rows(n // mesh.dp)] for a in arrays)


def _model(case, mesh):
    """(config, this rank's parameters requiring grad, their specs)."""
    cfg = PA.AcousticConfig(**case["cfg"])
    params = params_from_numpy(case["params"], "cpu")
    if mesh.pp > 1:
        params = dict(zip(("stacked", "rest"), PP.stack_layer_params(params, cfg)))
    specs = PP.pp_param_shardings(mesh, params) if mesh.pp > 1 else M.param_shardings(mesh, params)
    if mesh.pp > 1:
        params = M.shard_params(mesh, params, specs)
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    return cfg, params, specs


def _loss(case, cfg, mesh, params, inputs):
    x1, ph, cond = _rows(mesh, _tensors(case["batch"]), len(case["batch"][0]))
    if mesh.pp > 1:
        return PP.pp_cfm_loss(params, cfg, None, x1, ph, cond, mesh=mesh, num_microbatches=case["m"],
                              cond_drop_prob=case["drop"], inputs=inputs)
    return R.cfm_loss_sp(params, cfg, None, x1, ph, cond, mesh=mesh, cond_drop_prob=case["drop"], inputs=inputs)


def _counts():
    return (C.PPERMUTES, C.AXIS_SUMS)


def loss_and_grads(case, mesh) -> dict:
    """One forward and backward on the rank's rows with JAX's draws, the
    shares added and averaged as the train step does: the loss, the whole
    gradient tree (gathered), the norm, the first-half skip placeholders'
    local gradients, and the ppermutes / axis sums made."""
    cfg, params, specs = _model(case, mesh)
    inputs = _rows(mesh, _tensors(case["inputs"]), len(case["batch"][0]))
    before = _counts()
    loss = _loss(case, cfg, mesh, params, inputs)
    loss.backward()
    counts = [a - b for a, b in zip(_counts(), before)]
    leaves = [t for _, t in named_leaves(params)]
    grads = [t.grad for t in leaves]
    skip = {}
    if mesh.pp > 1:
        lpp = cfg.depth // mesh.pp
        for j in range(lpp):
            g = mesh.pp_rank * lpp + j
            if g < cfg.depth // 2:
                skip[g] = max(float(params["stacked"]["skip"][k].grad[j].abs().max()) for k in ("w", "b"))
    flat = list(specs.values())
    loss = TS.sync_sharded_grads(mesh, flat, grads, params, loss.detach())
    norm = TS.sharded_norm(mesh, flat, [t.grad for t in leaves])
    gtree = dict(zip(specs, [t.grad for t in leaves]))
    full = M.gather_params(mesh, gtree, specs)
    return {"loss": float(loss), "grad_norm": float(norm), "grads": _numpy_leaves(full), "skip": skip,
            "ppermutes": counts[0], "axis_sums": counts[1]}


def train_steps(case, mesh) -> dict:
    """`len(case["step_inputs"])` steps of the sharded train step, step i
    with JAX's draws of its key: the losses and grad norms, the gathered
    parameters, this rank's local parameters and EMA, the specs."""
    cfg, params, specs = _model(case, mesh)
    tcfg = loop.TrainConfig(lr=case["lr"])
    state = loop.init_train_state(params, tcfg)
    draws = iter(case["step_inputs"])

    def loss_fn(p, batch, generator):
        return _loss(case, cfg, mesh, p, _rows(mesh, _tensors(next(draws)), len(case["batch"][0])))

    step = TS.make_sharded_train_step(loss_fn, tcfg, mesh, specs)
    metrics = [{k: float(v) for k, v in step(state, {}, None).items()} for _ in case["step_inputs"]]
    return {"metrics": metrics, "params": _numpy_leaves(M.gather_params(mesh, state.params, specs)),
            "local": _numpy_leaves(state.params), "ema": _numpy_leaves(state.ema_params), "specs": specs}


def ring(case, mesh) -> dict:
    """ring_attention of the rank's frames of q, k, v, gathered."""
    q, k, v = (t[:, :, mesh.frames(t.shape[2] // mesh.sp)].to(getattr(torch, case["dtype"]))
               for t in _tensors(case["qkv"]))
    return {"out": C.axis_gather(mesh, "sp", R.ring_attention(q, k, v, mesh), 2).float().numpy()}


def halo(case, mesh) -> dict:
    """conv1d_halo of the rank's frames, gathered."""
    p = {k: torch.from_numpy(v) for k, v in case["p"].items()}
    x = torch.from_numpy(case["x"])
    x = x[:, mesh.frames(x.shape[1] // mesh.sp)]
    return {"out": C.axis_gather(mesh, "sp", R.conv1d_halo(p, x, case["kernel"], x.shape[-1], mesh), 1).numpy()}


def sample(case, mesh) -> dict:
    """sample_sp of the dp rows with JAX's y0 as noise."""
    cfg = PA.AcousticConfig(**case["cfg"])
    params = params_from_numpy(case["params"], "cpu")
    ph, cond, noise = _rows(mesh, _tensors((case["ph"], case["cond"], case["noise"])), len(case["ph"]))
    before = _counts()
    out = R.sample_sp(params, cfg, None, ph, cond, mesh=mesh, cond_scale=case["cond_scale"], noise=noise)
    return {"out": out.numpy(), "ppermutes": _counts()[0] - before[0]}


def collectives(case, mesh) -> dict:
    """ppermute by +1 and -1 and axis_sum, forward and backward, on
    rank-valued tensors (f32 and bf16), over the case's axis."""
    axis = case["axis"]
    _, n, i = mesh.axis_info(axis)
    r, out = i + 1.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for shift in (1, -1):
            a = torch.full((2, 3), r, dtype=dtype, requires_grad=True)
            b = torch.full((4,), 10 * r, dtype=dtype, requires_grad=True)
            ya, yb = C.ppermute(mesh, axis, [a, b], shift=shift)
            ((ya * r).sum() + (yb * 2 * r).sum()).backward()
            out[f"ppermute_{dtype}_{shift}"] = (ya.detach().float().numpy(), yb.detach().float().numpy(),
                                               a.grad.float().numpy(), b.grad.float().numpy())
    x = torch.full((3,), r, requires_grad=True)
    y = C.axis_sum(mesh, axis, x)
    (y * r).sum().backward()
    out["axis_sum"] = (y.detach().numpy(), x.grad.numpy())
    out["backend"] = M.backend(mesh.axis_info(axis)[0])
    return out


RUN = {"grads": loss_and_grads, "train": train_steps, "ring": ring, "halo": halo, "sample": sample,
       "collectives": collectives}


def run_cases(path: str) -> None:
    """The parent's cases, each as rank r of its mesh."""
    torch.set_num_threads(1)
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    meshes, out = {}, {"rank": dist.get_rank()}
    for name, case in cases.items():
        key = tuple(case["mesh"].items())
        if key not in meshes:
            meshes[key] = M.make_mesh(case["mesh"]["dp"], "cpu", **{k: v for k, v in case["mesh"].items()
                                                                   if k != "dp"})
        mesh = meshes[key]
        out[name] = {"dp_rank": mesh.dp_rank, "index": mesh.axis_info(mesh.axis)[2],
                     **RUN[case["kind"]](case, mesh)}
    with open(os.path.join(path, f"rank{out['rank']}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(path, cases: dict, world: int) -> list:
    """Spawn `world` gloo ranks on `cases` (with a collective timeout):
    each rank's results."""
    from covomix_tpu_torch.parallel import multihost as MH

    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump(cases, f)
    MH.spawn(run_cases, world, str(path), device="cpu", timeout=TIMEOUT_S)
    ranks = []
    for r in range(world):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks
