"""Shared pieces of the port's tensor-parallel and FSDP tests
(tests/test_torch_tp.py, tests/test_torch_fsdp.py): the tiny VoMix and CoMix
T2S cases, JAX's `make_sharded_train_step` on a dp x tp mesh of the
conftest's host devices, the port's ranks over gloo (tests/_torch_tp_child.py)
and the checks both files hold them to.

The cases are those of tests/test_torch_parallel.py: JAX's cfm_inputs are
handed to the port (the two packages draw different numbers) and the T2S
rows carry targets of unequal lengths, so only the global token count
gives JAX's loss. Tolerances as there: the loss and grad norm to 1e-5
relative (summation order only: the tp ranks' partial sums and the
sharded norm add in another order), the parameters after one Adam step to
2 lr and all but 0.1 % of the elements to 1e-2 lr; every part of the state
that two ranks both hold, bit for bit."""

from __future__ import annotations

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from covomix_tpu.models import acoustic as JA, text2semantic as JT
from covomix_tpu.parallel.mesh import make_mesh as jax_mesh
from covomix_tpu.parallel.train_step import init_sharded_state, make_sharded_train_step, shard_batch
from covomix_tpu.train import loop as JLoop
from covomix_tpu_torch.models import text2semantic as PT
from covomix_tpu_torch.parallel import multihost as MH
from covomix_tpu_torch.util.misc import named_leaves

import _torch_tp_child
from _torch_port import J_AC, J_T2S, P_AC, jax_params, port_cfg

B, T = 4, 64
LR = 1e-3
DROP = 0.3
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_TIGHT, PARAM_TIGHT_SHARE = 2 * LR, 1e-2 * LR, 1e-3
J_T2S_PAD = dataclasses.replace(J_T2S, semantic_pad_id=500)
T2S_LENS = (40, 33, 9, 4)


def _acoustic_params():
    """The tiny VoMix parameters with the adaptive norms' projections made
    random (zero at init, they would leave the time embedding untrained)."""
    rs = np.random.RandomState(11)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jax_params(0)[1])


def _acoustic_batch(rs):
    mask = np.zeros((B, T), bool)
    for i in range(B):
        s = rs.randint(0, T // 2)
        mask[i, s:s + T // 3] = True
    return {"x": (rs.randn(B, T, 240) * 0.5).astype(np.float32),
            "phonemes": rs.randint(0, 502, (B, T, 2)).astype(np.int32), "mask": mask}


def _t2s_batch(rs, lens=T2S_LENS):
    sem = np.full((len(lens), 48, 2), 500, np.int32)
    for i, n in enumerate(lens):
        sem[i, :n] = rs.randint(0, 500, (n, 2))
    text = np.zeros((len(lens), 16), np.int32)
    for i in range(len(lens)):
        text[i, :10 + i] = rs.randint(1, 199, 10 + i)
    return {"text_ids": text, "semantic_ids": sem}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def jax_step(loss_fn, params, batch, key, dp, tp, fsdp, grad_accum=1):
    """JAX's make_sharded_train_step on a dp x tp mesh: (metrics, params)."""
    cfg = JLoop.TrainConfig(lr=LR, grad_accum=grad_accum)
    mesh = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    with jax.default_matmul_precision("highest"), mesh:
        state, p_shard = init_sharded_state(params, cfg, mesh, tp=tp > 1, fsdp=fsdp)
        step = make_sharded_train_step(loss_fn, cfg, mesh, p_shard)
        new, m = step(state, shard_batch(mesh, jax.tree_util.tree_map(jnp.asarray, batch), accum=grad_accum > 1),
                      key)
        return {k: float(v) for k, v in m.items()}, dict(named_leaves(jax.device_get(new.params)))


def cases(models, dp, tp, fsdp, accum_t2s=False):
    """(JAX results, the ranks' cases) for `models` on a dp x tp mesh:
    'acoustic', 't2s', and 't2s_heads3' (3 heads, which tp=2 does not
    divide: every split attention leaf gathered); with `accum_t2s` also the
    T2S step over 2 micro-batches ('t2s_accum2')."""
    rs = np.random.RandomState(0)
    key = jax.random.PRNGKey(7)
    jax_results, port = {}, {}
    if "acoustic" in models:
        params, batch = _acoustic_params(), _acoustic_batch(rs)
        x = jnp.asarray(batch["x"])
        with jax.default_matmul_precision("highest"):
            inputs = JA.cfm_inputs(J_AC, key, x[..., -80:], x[..., :-80], jnp.asarray(batch["mask"]),
                                   cond_drop_prob=DROP)
        port["acoustic"] = {"model": "acoustic", "cfg": dataclasses.asdict(P_AC), "params": _np(params),
                            "batch": batch, "inputs": tuple(None if a is None else np.array(a) for a in inputs),
                            "drop": DROP, "train_cfg": {"lr": LR}}
        jax_results["acoustic"] = jax_step(JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP), params, batch, key,
                                           dp, tp, fsdp)
    # numpy copies first: the JAX step donates the state it is given
    t2s_np = _np(jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(4), J_T2S_PAD))
    t2s_cfg = dataclasses.asdict(port_cfg(PT.T2SConfig, J_T2S_PAD))
    fresh = lambda: jax.tree_util.tree_map(jnp.asarray, t2s_np)
    if "t2s" in models:
        batch = _t2s_batch(rs)
        port["t2s"] = {"model": "t2s", "cfg": t2s_cfg, "params": t2s_np, "batch": batch, "train_cfg": {"lr": LR}}
        jax_results["t2s"] = jax_step(JLoop.t2s_loss_fn(J_T2S_PAD), fresh(), batch, key, dp, tp, fsdp)
    if "t2s_heads3" in models:
        cfg = dataclasses.replace(J_T2S_PAD, heads=3)
        params = _np(jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(5), cfg))
        batch = _t2s_batch(rs)
        port["t2s_heads3"] = {"model": "t2s", "cfg": dataclasses.asdict(port_cfg(PT.T2SConfig, cfg)),
                              "params": params, "batch": batch, "train_cfg": {"lr": LR}}
        jax_results["t2s_heads3"] = jax_step(JLoop.t2s_loss_fn(cfg), jax.tree_util.tree_map(jnp.asarray, params),
                                             batch, key, dp, tp, fsdp)
    if accum_t2s:
        micro = [_t2s_batch(rs, lens) for lens in (T2S_LENS, (7, 30, 12, 25))]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        port["t2s_accum2"] = {"model": "t2s", "cfg": t2s_cfg, "params": t2s_np, "batch": batch,
                              "train_cfg": {"lr": LR, "grad_accum": 2}}
        jax_results["t2s_accum2"] = jax_step(JLoop.t2s_loss_fn(J_T2S_PAD), fresh(), batch, key, dp, tp, fsdp,
                                             grad_accum=2)
    return jax_results, port


def run_ranks(path, port_cases, dp, tp, fsdp) -> list:
    """The port's dp x tp ranks over gloo on `port_cases`: each rank's results."""
    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump({"cases": port_cases, "dp": dp, "tp": tp, "fsdp": fsdp}, f)
    MH.spawn(_torch_tp_child.train_steps, dp * tp, str(path), device="cpu")
    ranks = []
    for r in range(dp * tp):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def check_against_jax(jax_result, ranks, name):
    """Every rank's loss and grad norm against JAX's mesh step, and its
    gathered parameters as the module docstring says."""
    jm, jparams = jax_result
    for res in ranks:
        got = res[name]
        np.testing.assert_allclose(got["loss"], jm["loss"], rtol=LOSS_RTOL, err_msg=name)
        np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"], rtol=LOSS_RTOL, err_msg=name)
        assert got["params"].keys() == jparams.keys()
        far = total = 0
        for leaf, p in got["params"].items():
            assert p.shape == jparams[leaf].shape, leaf
            np.testing.assert_allclose(p, jparams[leaf], rtol=0, atol=PARAM_ATOL, err_msg=leaf)
            far += int(np.sum(np.abs(p - jparams[leaf]) > PARAM_TIGHT))
            total += p.size
        assert far <= PARAM_TIGHT_SHARE * total, (far, total)


def check_replicas(ranks, name):
    """Each part of the state that two ranks both hold (the same tp block, or
    none, and the same dp block, or none) is bit-equal on both: parameters
    and EMA after the step; every rank's loss and grad norm too."""
    specs = ranks[0][name]["specs"]
    compared = 0
    for a in ranks:
        for b in ranks:
            if b["rank"] <= a["rank"]:
                continue
            assert (a[name]["loss"], a[name]["grad_norm"]) == (b[name]["loss"], b[name]["grad_norm"])
            for leaf, spec in specs.items():
                if (("tp" not in spec or a["tp_rank"] == b["tp_rank"])
                        and ("dp" not in spec or a["dp_rank"] == b["dp_rank"])):
                    for part in ("local", "ema"):
                        np.testing.assert_array_equal(a[name][part][leaf], b[name][part][leaf], err_msg=leaf)
                    compared += 1
    return compared
