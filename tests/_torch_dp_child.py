"""The rank processes of the port's data-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_gan_dp.py).

`covomix_tpu_torch.parallel.multihost.spawn` starts them over gloo on the
CPU. Each reads the parent's cases from `<dir>/inputs.pkl` (numpy trees and
config dicts), runs them as rank r of the process group and writes its
results to `<dir>/rank<r>.pkl`. Nothing here imports jax: the ranks are the
port alone, and the parent holds them against the JAX package."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from covomix_tpu_torch.audio.mel import MelConfig
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV
from covomix_tpu_torch.parallel import multihost as MH, train_step as TS
from covomix_tpu_torch.parallel.mesh import make_mesh
from covomix_tpu_torch.train import gan as PG, loop
from covomix_tpu_torch.util.misc import named_leaves


def _read(path):
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _write(path, mesh, out):
    with open(os.path.join(path, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _numpy_leaves(tree) -> dict:
    return {n: t.detach().numpy().copy() for n, t in named_leaves(tree)}


def _train_step(case, mesh):
    """One data-parallel step of the case's model on this rank's rows."""
    params = params_from_numpy(case["params"], "cpu")
    tcfg = loop.TrainConfig(**case["train_cfg"])
    if case["model"] == "acoustic":
        cfg = PA.AcousticConfig(**case["cfg"])
        b = len(case["batch"]["x"]) // mesh.dp
        inputs = tuple(None if a is None else torch.from_numpy(a[mesh.rows(b)]) for a in case["inputs"])

        def loss_fn(p, batch, generator):
            x = batch["x"]
            return PA.cfm_loss(p, cfg, generator, x[..., -80:], batch["phonemes"], x[..., :-80], batch["mask"],
                               cond_drop_prob=case["drop"], inputs=inputs, mesh=mesh)
    else:
        loss_fn = loop.t2s_loss_fn(PT.T2SConfig(**case["cfg"]), mesh=mesh)
    state, specs = TS.init_sharded_state(params, tcfg, mesh)
    step = TS.make_sharded_train_step(loss_fn, tcfg, mesh, specs)
    syncs = TS.GRAD_SYNCS
    m = step(state, TS.shard_batch(mesh, case["batch"]), None)
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "params": _numpy_leaves(state.params),
            "syncs": TS.GRAD_SYNCS - syncs}


def _own_draws(case, mesh):
    """The losses of this rank's rows with the port's own draws from a
    generator seeded alike on every rank: the acoustic training mask, noise,
    times and cond-drop, and the T2S cond-drop."""
    b = len(case["x1"]) // mesh.dp
    rows = {k: torch.from_numpy(v[mesh.rows(b)]) for k, v in case.items() if k not in ("ac", "t2s")}
    ac_cfg, ac_params = PA.AcousticConfig(**case["ac"]["cfg"]), params_from_numpy(case["ac"]["params"], "cpu")
    t2s_cfg, t2s_params = PT.T2SConfig(**case["t2s"]["cfg"]), params_from_numpy(case["t2s"]["params"], "cpu")
    with torch.no_grad():
        ac = PA.cfm_loss(ac_params, ac_cfg, torch.Generator().manual_seed(5), rows["x1"], rows["phonemes"],
                         rows["cond"], cond_drop_prob=0.5, mesh=mesh)
        t2s = PT.forward_loss(t2s_params, t2s_cfg, rows["text_ids"], rows["semantic_ids"],
                              generator=torch.Generator().manual_seed(6), cond_drop=True, mesh=mesh)
    return {"acoustic": ac.item(), "t2s": t2s.item()}


def _reconcile(mesh):
    """A batch whose trailing dims differ by rank, padded to the ranks' max."""
    r = mesh.rank
    batch = {"x": np.ones((2, 10 + 6 * r, 3), np.float32), "mask": np.ones((2, 10 + 6 * r), bool),
             "semantic_ids": np.full((2, 4 + 3 * r, 2), 7, np.int32), "text_ids": np.full((2, 5 - 2 * r), 9, np.int32),
             "durations": np.full((2,), 3, np.int32)}
    return {k: v.numpy() for k, v in MH.reconcile_batch(batch, "cpu").items()}


def train_steps(path: str) -> None:
    """The acoustic and T2S steps, the own-draw losses, reconcile_batch and
    the process slice of this rank."""
    torch.set_num_threads(1)
    inp = _read(path)
    mesh = make_mesh(0, "cpu")
    out = {name: _train_step(case, mesh) for name, case in inp["steps"].items()}
    out.update(own_draws=_own_draws(inp["own_draws"], mesh), reconcile=_reconcile(mesh),
               slice=MH.process_batch_slice(8), primary=MH.is_primary(), dp=mesh.dp, rank=mesh.rank)
    _write(path, mesh, out)


def gan_step(path: str) -> None:
    """One data-parallel GAN step from the parent's state on this rank's
    rows of the batch."""
    torch.set_num_threads(2)
    inp = _read(path)
    mesh = make_mesh(0, "cpu")
    cfg = PG.GanConfig(**inp["gan_cfg"])
    gen, mpd, msd = (params_from_numpy(inp[k], "cpu") for k in ("gen", "mpd", "msd"))
    state = PG.make_gan_state(gen, mpd, msd, cfg)
    step = PG.make_gan_step(PV.VocoderConfig(**inp["voc_cfg"]), MelConfig(), MelConfig(), cfg, mesh=mesh)
    syncs = TS.GRAD_SYNCS
    m = step(state, {"audio": torch.from_numpy(TS.shard_batch(mesh, {"audio": inp["audio"]})["audio"])})
    _write(path, mesh, {"metrics": {k: v.item() for k, v in m.items()}, "syncs": TS.GRAD_SYNCS - syncs,
                        "gen": _numpy_leaves(state.gen_params), "d": _numpy_leaves(state.d_params)})
