"""The rank processes of the port's BMUF and dp-serving tests
(tests/test_torch_bmuf.py, tests/test_torch_serving_dp.py).

`covomix_tpu_torch.parallel.multihost.spawn` starts them over gloo on the
CPU. Each reads the parent's cases from `<dir>/inputs.pkl` (numpy trees,
config dicts and JAX's draws), runs them as rank r of a dp mesh and writes
its results to `<dir>/rank<r>.pkl`. Nothing here imports jax: the ranks are
the port alone, and the parent holds them against the JAX package (or
against the port's one-device pipeline)."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV
from covomix_tpu_torch.parallel import bmuf as BM, collectives as C, mesh as M, train_step as TS
from covomix_tpu_torch.serving import BatchedPipeline
from covomix_tpu_torch.train import loop
from covomix_tpu_torch.util.misc import named_leaves, tree_map

TIMEOUT_S = 120.0     # a collective out of step fails the test instead of hanging the suite


def _read(path):
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _write(path, mesh, out):
    with open(os.path.join(path, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _numpy_leaves(tree) -> dict:
    return {n: t.detach().float().numpy().copy() for n, t in named_leaves(tree)}


def _updates(case, mesh):
    """bmuf_update on this rank's row of the case's stacked trees."""
    row = lambda tree: tree_map(lambda a: torch.from_numpy(np.array(a[mesh.dp_rank])), tree)
    params = row(case["params"])
    state = {"global": row(case["global"]), "smoothed": row(case["smoothed"]), "t": case["t"]}
    syncs = BM.SYNCS
    kind = BM.bmuf_update(params, state, BM.BMUFConfig(**case["cfg"]), mesh)
    return {"kind": kind, "params": _numpy_leaves(params), "global": _numpy_leaves(state["global"]),
            "smoothed": _numpy_leaves(state["smoothed"]), "t": state["t"], "syncs": BM.SYNCS - syncs}


def _loss_fn(case, inputs):
    """The case's plain loss (no mesh: a BMUF rank's loss is its own rows');
    the acoustic one on the draws in inputs["now"], JAX's for this rank and
    step."""
    if case["model"] == "t2s":
        return loop.t2s_loss_fn(PT.T2SConfig(**case["cfg"]))
    cfg = PA.AcousticConfig(**case["cfg"])

    def loss(p, batch, generator):
        x = batch["x"]
        return PA.cfm_loss(p, cfg, generator, x[..., -80:], batch["phonemes"], x[..., :-80], batch["mask"],
                           cond_drop_prob=case["drop"], inputs=inputs["now"])

    return loss


def _steps(case, mesh):
    """The case's BMUF steps on this rank's rows: per step the metrics, the
    branch's sync collectives, the gradient all-reduces (none) and Adam's
    learning rate; then the rank's parameters, EMA, Adam moments and count
    and BMUF state."""
    tcfg = loop.TrainConfig(**case["train_cfg"])
    bcfg = BM.BMUFConfig(**case["bmuf_cfg"])
    state = loop.init_train_state(params_from_numpy(case["params"], "cpu"), tcfg)
    bstate = BM.init_bmuf_state(state.params)
    inputs = {}
    step = BM.make_bmuf_train_step(_loss_fn(case, inputs), tcfg, bcfg, mesh, bstate)
    recs = []
    for i, batch in enumerate(case["batches"]):
        if case["inputs"] is not None:
            inputs["now"] = tuple(None if a is None else torch.from_numpy(a) for a in case["inputs"][i][mesh.dp_rank])
        before = (BM.SYNCS, BM.SYNC_BYTES, TS.GRAD_SYNCS)
        m = step(state, TS.shard_batch(mesh, batch), None)
        recs.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "syncs": BM.SYNCS - before[0],
                     "sync_bytes": BM.SYNC_BYTES - before[1], "grad_syncs": TS.GRAD_SYNCS - before[2],
                     "lr": state.optimizer.param_groups[0]["lr"], "t": bstate["t"]})
    opt = state.optimizer
    moments = {k: {n: opt.state[p][slot].numpy().copy() for n, p in named_leaves(state.params)}
               for k, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    return {"steps": recs, "params": _numpy_leaves(state.params), "ema": _numpy_leaves(state.ema_params),
            "count": int(opt.state[next(iter(opt.state))]["step"]), **moments,
            "global": _numpy_leaves(bstate["global"]), "smoothed": _numpy_leaves(bstate["smoothed"]),
            "ema_num_updates": state.ema_num_updates, "step": state.step,
            "param_bytes": sum(p.numel() * p.element_size() for _, p in named_leaves(state.params))}


def _regularizer(case, mesh):
    """alignment_regularizer over dp on this rank's rows, and its gradients."""
    rows = lambda a: torch.from_numpy(a[mesh.rows(len(a) // mesh.dp)])
    s, t = rows(case["source"]).requires_grad_(True), rows(case["target"]).requires_grad_(True)
    loss = C.alignment_regularizer(s, t, rows(case["source_mask"]), rows(case["target_mask"]), mesh=mesh,
                                   use_logsumexp_pool=case["pool"])
    loss.backward()
    return {"loss": loss.item(), "source_grad": s.grad.numpy(), "target_grad": t.grad.numpy()}


def bmuf_rank(path: str) -> None:
    """The parent's bmuf_update cases, BMUF step cases and regularizer
    cases as rank r of a dp mesh."""
    torch.set_num_threads(1)
    inp = _read(path)
    mesh = M.make_mesh(inp["dp"], "cpu")
    out = {"rank": mesh.rank, "updates": {k: _updates(c, mesh) for k, c in inp["updates"].items()},
           "steps": {k: _steps(c, mesh) for k, c in inp["steps"].items()},
           "regularizer": {k: _regularizer(c, mesh) for k, c in inp["regularizer"].items()}}
    _write(path, mesh, out)


def pipelines(case, mesh=None):
    """The case's BatchedPipeline on the CPU, over `mesh` or on one device."""
    kw = dict(decode_len=case["decode"], dtype=torch.float32, device="cpu", mesh=mesh,
              top_k_thres=case["top_k_thres"], speculative=case["speculative"])
    return BatchedPipeline(case["t2s"], PT.T2SConfig(**case["t2s_cfg"]), case["ac"],
                           PA.AcousticConfig(**case["ac_cfg"]), case["voc"], PV.VocoderConfig(**case["voc_cfg"]),
                           **kw)


def serve(case, mesh=None) -> dict:
    """One call of the case's pipeline on its inputs with a generator seeded
    from the case: the wav, the GenerateResult and the generator's next draw."""
    pipe = pipelines(case, mesh)
    gen = torch.Generator().manual_seed(case["seed"])
    args = case["inputs"] if mesh is None else pipe.place(*case["inputs"])
    wav, res = pipe(gen, *args)
    return {"wav": wav.numpy(), "tokens": res.tokens.numpy(), "tokens2": res.tokens2.numpy(),
            "lengths": res.lengths.numpy(), "lengths2": res.lengths2.numpy(), "num_steps": res.num_steps,
            "next_draw": torch.rand(4, generator=gen).numpy()}


def serving_rank(path: str) -> None:
    """The parent's pipeline cases as rank r of a dp mesh, then serve_batch's
    serving of the parent's scripts over the same mesh (rank 0 writes)."""
    from covomix_tpu_torch import serve_batch

    torch.set_num_threads(1)
    inp = _read(path)
    mesh = M.make_mesh(inp["dp"], "cpu")
    _write(path, mesh, {"rank": mesh.rank, **{name: serve(case, mesh) for name, case in inp["cases"].items()}})
    serve_batch.serve(serve_batch.parse_args(inp["serve_batch"]), mesh.device, mesh=mesh)
