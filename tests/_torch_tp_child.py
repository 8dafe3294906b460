"""The rank processes of the port's tensor-parallel and FSDP tests
(tests/test_torch_tp.py, tests/test_torch_fsdp.py, tests/test_torch_tp_cli.py).

`covomix_tpu_torch.parallel.multihost.spawn` starts them over gloo on the
CPU. Each reads the parent's mesh and cases from `<dir>/inputs.pkl` (numpy
trees and config dicts), runs them as rank r of a dp x tp mesh and writes
its results to `<dir>/rank<r>.pkl`. Nothing here imports jax: the ranks are
the port alone, and the parent holds them against the JAX package."""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT
from covomix_tpu_torch.parallel import mesh as M, multihost as MH, tensor as TPX, train_step as TS
from covomix_tpu_torch.train import cli, loop
from covomix_tpu_torch.util.misc import named_leaves


def _read(path):
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _numpy_leaves(tree) -> dict:
    return {n: t.detach().numpy().copy() for n, t in named_leaves(tree)}


def _loss_fn(case, mesh):
    if case["model"] == "t2s":
        return loop.t2s_loss_fn(PT.T2SConfig(**case["cfg"]), mesh=mesh)
    cfg = PA.AcousticConfig(**case["cfg"])
    b = len(case["batch"]["x"]) // mesh.dp
    inputs = tuple(None if a is None else torch.from_numpy(a[mesh.rows(b)]) for a in case["inputs"])

    def loss(p, batch, generator):
        x = batch["x"]
        return PA.cfm_loss(p, cfg, generator, x[..., -80:], batch["phonemes"], x[..., :-80], batch["mask"],
                           cond_drop_prob=case["drop"], inputs=inputs, mesh=mesh)

    return loss


def _sharded_step(case, mesh, fsdp):
    """One step of the case's model on this rank's parts and rows."""
    tcfg = loop.TrainConfig(**case["train_cfg"])
    state, specs = TS.init_sharded_state(params_from_numpy(case["params"], "cpu"), tcfg, mesh, fsdp=fsdp)
    step = TS.make_sharded_train_step(_loss_fn(case, mesh), tcfg, mesh, specs)
    before = (TPX.COLLECTIVES, TS.GRAD_SYNCS, TS.PARAM_GATHERS)
    m = step(state, TS.shard_batch(mesh, case["batch"], accum=tcfg.grad_accum > 1), None)
    counts = (TPX.COLLECTIVES - before[0], TS.GRAD_SYNCS - before[1], TS.PARAM_GATHERS - before[2])
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "specs": specs,
            "params": _numpy_leaves(M.gather_params(mesh, state.params, specs)),
            "local": _numpy_leaves(state.params), "ema": _numpy_leaves(state.ema_params),
            "tp_collectives": counts[0], "grad_syncs": counts[1], "param_gathers": counts[2]}


def _roundtrip(params_np, mesh, fsdp) -> bool:
    """gather_params(shard_params(tree)) bit for bit, -0.0 and NaN among the
    values."""
    params = params_from_numpy(params_np, "cpu")
    for t in (p for _, p in named_leaves(params)):
        t.view(-1)[:2] = torch.tensor([-0.0, float("nan")])
    specs = M.param_shardings(mesh, params, fsdp=fsdp)
    full = M.gather_params(mesh, M.shard_params(mesh, params, specs), specs)
    return all(a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip(_numpy_leaves(full).values(), _numpy_leaves(params).values()))


def _collectives(mesh) -> dict:
    """copy_to_tp / reduce_from_tp / gather_from_tp forward and backward on
    rank-valued tensors (bf16 and f32), and all_gather / reduce_scatter over
    each axis."""
    r, out = mesh.tp_rank + 1.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((2, 3), r, dtype=dtype, requires_grad=True)
        y = TPX.copy_to_tp(mesh, x)
        (y * r).sum().backward()
        out[f"copy_{dtype}"] = (y.detach().float().numpy(), x.grad.float().numpy())
        x = torch.full((2, 3), r, dtype=dtype, requires_grad=True)
        y = TPX.reduce_from_tp(mesh, x)
        (y * r).sum().backward()
        out[f"reduce_{dtype}"] = (y.detach().float().numpy(), x.grad.float().numpy())
        x = torch.full((2, 3), r, dtype=dtype, requires_grad=True)
        y = TPX.gather_from_tp(mesh, x, dim=1)
        (y * torch.arange(y.shape[1], dtype=dtype)).sum().backward()
        out[f"gather_{dtype}"] = (y.detach().float().numpy(), x.grad.float().numpy())
    t = torch.arange(4.0).reshape(2, 2) + 10 * mesh.rank
    out["dp_gather"] = M.all_gather(t, 1, mesh.dp_group, mesh.dp, mesh.dp_rank).numpy()
    out["dp_scatter"] = M.reduce_scatter(t.repeat(mesh.dp, 1), 0, mesh.dp_group, mesh.dp, mesh.dp_rank).numpy()
    out["backend"] = M.backend(mesh.tp_group if mesh.tp > 1 else mesh.dp_group)
    return out


def train_steps(path: str) -> None:
    """The parent's cases as rank r of its dp x tp mesh: the sharded steps,
    the shard / gather round trip and the collectives."""
    torch.set_num_threads(1)
    inp = _read(path)
    mesh = M.make_mesh(inp["dp"], "cpu", tp=inp["tp"])
    out = {"rank": mesh.rank, "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp_rank, "dp": mesh.dp, "tp": mesh.tp,
           "collectives": _collectives(mesh),
           "roundtrip": {name: _roundtrip(case["params"], mesh, inp["fsdp"]) for name, case in inp["cases"].items()},
           "slices": _slices(mesh)}
    for name, case in inp["cases"].items():
        out[name] = _sharded_step(case, mesh, inp["fsdp"])
    with open(os.path.join(path, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _slices(mesh):
    """This rank's process slice of a global batch of 8 and its items of a
    10-item dataset."""
    s = MH.process_batch_slice(8, mesh)
    shard = MH.ProcessShardDataset(list(range(10)), mesh=mesh)
    return (s.start, s.stop), [shard[i] for i in range(len(shard))]


def cli_rank(argv) -> None:
    """`train.cli.main(argv)` in a rank of an existing process group (the
    `--multihost` refusal test): the SystemExit's message, written out."""
    rank = torch.distributed.get_rank()
    try:
        cli.main(argv)
        msg = None
    except SystemExit as e:
        msg = str(e.code)
    with open(os.path.join(argv[argv.index("--log_dir") + 1], f"exit{rank}.txt"), "w") as f:
        f.write(repr(msg))
    sys.stdout.flush()
