"""BMUF (parallel/bmuf.py) and the alignment regularizer's all-gather
(parallel/collectives.py) against the JAX package, two gloo ranks on the
CPU (one spawn; the ranks' bodies in tests/_torch_bmuf_child.py) against
JAX's shard_map over two of the conftest's host devices:

  * `bmuf_update`: block sync, Nesterov, a noop between syncs, momentum 0,
    the warmup broadcast and average (tests/test_bmuf.py's cases), each
    rank's parameters and block state to 1e-6 (the same f32 ops; JAX's
    XLA may contract a multiply-add), one collective on a sync and none on
    a noop;
  * the BMUF step over 6 steps at dp=2 (warmup 1, sync 2, the default
    momentum 0.5) of a tiny VoMix model (JAX's cfm_inputs of each worker
    and step handed to the port; grad clip 1) and of a tiny CoMix T2S
    (unequal target lengths, the lr schedule at one step an epoch, so the
    learning rate after the warmup reset shows), against JAX's
    make_bmuf_train_step: the reported loss and grad norm (means over dp)
    to 1e-5 relative, each worker's parameters, EMA, Adam moments and
    BMUF trees to a few learning rates (module constants), Adam's count
    and the learning rates exactly, no gradient all-reduce, one sync
    collective of the parameters' bytes on steps 1, 2, 4 and 6;
  * `alignment_regularizer` and its gradients with `mesh=None` and over
    dp=2 (`all_gather_batch`, whose backward reduce-scatters), logsumexp
    and max pools, with and without an all-masked row, to 1e-5, against
    JAX's one-device form and its shard_map form (where that is finite:
    SHARD_MAP_NAN)."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from covomix_tpu.models import acoustic as JA
from covomix_tpu.parallel import bmuf as JB, collectives as JC
from covomix_tpu.train import loop as JLoop
from covomix_tpu_torch.parallel import bmuf as PB, collectives as PC
from covomix_tpu_torch.parallel import multihost as MH
from covomix_tpu_torch.util.misc import named_leaves

import _torch_bmuf_child
from _torch_port import J_AC, P_AC, port_cfg
from _torch_tp_cases import J_T2S_PAD, T2S_LENS, _acoustic_batch, _acoustic_params, _np, _t2s_batch

DP = 2
STEPS = 6
LR = 1e-3
DROP = 0.3
BMUF_CFG = {"sync_every": 2, "warmup_steps": 1}
UPDATE_ATOL = 1e-6
LOSS_RTOL = 1e-5
# after 6 steps: Adam moves an element by at most ~1.0055 lr a step, and two runs whose gradients differ at
# rounding level differ by at most twice that where a near-zero gradient flips sign; the block syncs
# (momentum 0.5, Nesterov) mix the workers' models and scale a difference by at most 1 + 2 * 0.5 = 2
PARAM_ATOL = 2 * 2 * 1.0055 * STEPS * LR
PARAM_TIGHT, PARAM_TIGHT_SHARE = 1e-2 * LR, 1e-3
REG_TOL = 1e-5


def _jax_mesh():
    return JMesh(np.array(jax.devices()[:DP]), ("dp",))


# ---------------------------------------------------------------------------
# bmuf_update


def _update_case(t, **kw):
    rs = np.random.RandomState(0)
    g = rs.randn(1, 3, 5).astype(np.float32).repeat(DP, 0)
    return {"params": {"w": rs.randn(DP, 3, 5).astype(np.float32)}, "global": {"w": g},
            "smoothed": {"w": rs.randn(1, 3, 5).astype(np.float32).repeat(DP, 0) * 0.1}, "t": t,
            "cfg": kw}


UPDATES = {"block_sync": _update_case(3, sync_every=4, block_momentum=0.75, block_lr=0.9, use_nbm=False),
           "nesterov": _update_case(3, sync_every=4, block_momentum=0.5, block_lr=1.0, use_nbm=True),
           "noop": _update_case(1, sync_every=4, block_momentum=0.75),
           "momentum0": _update_case(3, sync_every=4, block_momentum=0.0),
           "warmup_broadcast": _update_case(1, sync_every=100, block_momentum=0.9, warmup_steps=2),
           "warmup_average": _update_case(1, sync_every=100, block_momentum=0.9, warmup_steps=2,
                                          average_sync=True),
           "default_momentum": _update_case(5, sync_every=3)}


def _jax_update(case):
    """JAX's bmuf_update tick per worker under shard_map."""
    def tick(p, s):
        sq = lambda tr: jax.tree_util.tree_map(lambda x: x[0], tr)
        ex = lambda tr: jax.tree_util.tree_map(lambda x: x[None], tr)
        p2, s2 = JB.bmuf_update(sq(p), sq(s), JB.BMUFConfig(**case["cfg"]), axis_name="dp")
        return ex(p2), ex(s2)

    state = {"global": case["global"], "smoothed": case["smoothed"], "t": np.full((DP,), case["t"], np.int32)}
    fn = jax.shard_map(tick, mesh=_jax_mesh(), in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
                       check_vma=False)
    return _np(jax.jit(fn)(case["params"], state))


# ---------------------------------------------------------------------------
# the BMUF step


def _jax_bmuf(loss_fn, params, batches, keys, tcfg):
    """JAX's make_bmuf_train_step over the steps: (metrics, stacked state)."""
    mesh = _jax_mesh()
    bcfg = JB.BMUFConfig(**BMUF_CFG)
    with jax.default_matmul_precision("highest"):
        st0 = JLoop.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tcfg)
        state = JB.stack_for_bmuf(st0, JB.init_bmuf_state(st0.params), mesh)
        step = JB.make_bmuf_train_step(loss_fn, tcfg, bcfg, mesh)
        metrics = []
        for batch, key in zip(batches, keys):
            b = {k: jnp.asarray(v).reshape((DP, len(v) // DP) + v.shape[1:]) for k, v in batch.items()}
            state, m = step(state, b, key)
            metrics.append({k: float(np.asarray(v)[0]) for k, v in m.items()})
        return metrics, _np(state)


def _worker_inputs(batch, key):
    """JAX's cfm_inputs of each worker (its rows, the key folded with its index)."""
    out = []
    for w in range(DP):
        rows = slice(w * len(batch["x"]) // DP, (w + 1) * len(batch["x"]) // DP)
        x = jnp.asarray(batch["x"][rows])
        with jax.default_matmul_precision("highest"):
            res = JA.cfm_inputs(J_AC, jax.random.fold_in(key, w), x[..., -80:], x[..., :-80],
                                jnp.asarray(batch["mask"][rows]), cond_drop_prob=DROP)
        out.append(tuple(None if a is None else np.array(a) for a in res))
    return out


def _step_cases():
    rs = np.random.RandomState(0)
    keys = list(jax.random.split(jax.random.PRNGKey(7), STEPS))
    jax_results, port = {}, {}
    params = _np(_acoustic_params())
    batches = [_acoustic_batch(rs) for _ in range(STEPS)]
    train_cfg = {"lr": LR, "grad_clip": 1.0}
    port["acoustic"] = {"model": "acoustic", "cfg": dataclasses.asdict(P_AC), "params": params, "batches": batches,
                        "inputs": [_worker_inputs(b, k) for b, k in zip(batches, keys)], "drop": DROP,
                        "train_cfg": train_cfg, "bmuf_cfg": BMUF_CFG}
    jax_results["acoustic"] = _jax_bmuf(JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP), params, batches, keys,
                                        JLoop.TrainConfig(**train_cfg))
    from covomix_tpu.models import text2semantic as JT
    from covomix_tpu_torch.models import text2semantic as PT

    t2s = _np(jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(4), J_T2S_PAD))
    batches = [_t2s_batch(rs, T2S_LENS[i % 2:] + T2S_LENS[:i % 2]) for i in range(STEPS)]
    train_cfg = {"lr": LR, "use_lr_schedule": True, "steps_per_epoch": 1, "wake_up_epochs": 15}
    port["t2s"] = {"model": "t2s", "cfg": dataclasses.asdict(port_cfg(PT.T2SConfig, J_T2S_PAD)), "params": t2s,
                   "batches": batches, "inputs": None, "train_cfg": train_cfg, "bmuf_cfg": BMUF_CFG}
    jax_results["t2s"] = _jax_bmuf(JLoop.t2s_loss_fn(J_T2S_PAD), t2s, batches, keys, JLoop.TrainConfig(**train_cfg))
    return jax_results, port


# ---------------------------------------------------------------------------
# the regularizer


def _regularizer_case(pool, empty_row=True):
    rs = np.random.RandomState(5)
    sm, tm = rs.rand(4, 7) > 0.3, rs.rand(4, 9) > 0.3
    sm[2] = not empty_row               # an all-masked row (empty text)
    return {"source": rs.randn(4, 7, 8).astype(np.float32), "target": rs.randn(4, 9, 8).astype(np.float32),
            "source_mask": sm, "target_mask": tm, "pool": pool}


REGULARIZERS = {"logsumexp": _regularizer_case(True), "max": _regularizer_case(False),
                "logsumexp_no_empty_row": _regularizer_case(True, empty_row=False)}
# JAX's shard_map form on XLA:CPU takes the logsumexp of an all-masked row's -1e30 / temp fill to -inf and the
# loss to nan (its one-device form stays finite); that case is held to JAX's one-device form alone
SHARD_MAP_NAN = {"logsumexp"}


def _jax_regularizer(case, axis_name):
    """(loss, source grad, target grad) of JAX's regularizer: on one device,
    or per device under shard_map over dp (each device's gradient of its
    copy of the loss, as the port's ranks take it)."""
    def f(s, t, sm, tm):
        loss, (gs, gt) = jax.value_and_grad(lambda a, b: JC.alignment_regularizer(
            a, b, sm, tm, axis_name=axis_name, use_logsumexp_pool=case["pool"]), argnums=(0, 1))(s, t)
        return (loss if axis_name is None else loss[None]), gs, gt

    args = tuple(jnp.asarray(case[k]) for k in ("source", "target", "source_mask", "target_mask"))
    if axis_name is not None:
        f = jax.shard_map(f, mesh=_jax_mesh(), in_specs=(P("dp"),) * 4, out_specs=(P("dp"),) * 3, check_vma=False)
    return _np(jax.jit(f)(*args))


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("bmuf")
    jax_steps, port_steps = _step_cases()
    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump({"dp": DP, "updates": UPDATES, "steps": port_steps, "regularizer": REGULARIZERS}, f)
    MH.spawn(_torch_bmuf_child.bmuf_rank, DP, str(path), device="cpu", timeout=_torch_bmuf_child.TIMEOUT_S)
    out = []
    for r in range(DP):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return {"ranks": out, "jax_steps": jax_steps}


@pytest.mark.parametrize("name", list(UPDATES))
def test_bmuf_update_matches_jax(ranks, name):
    case = UPDATES[name]
    jp, js = _jax_update(case)
    kind = PB.branch(case["t"] + 1, PB.BMUFConfig(**case["cfg"]))
    for res in ranks["ranks"]:
        got, r = res["updates"][name], res["rank"]
        assert got["kind"] == kind and got["t"] == case["t"] + 1 == int(js["t"][r])
        assert got["syncs"] == (0 if kind == "noop" else 1)
        for part, ref in (("params", jp["w"]), ("global", js["global"]["w"]), ("smoothed", js["smoothed"]["w"])):
            np.testing.assert_allclose(got[part]["w"], ref[r], rtol=0, atol=UPDATE_ATOL, err_msg=f"{name} {part}")
    if kind != "noop":      # every rank holds the synced model, bit for bit
        a, b = (res["updates"][name]["params"]["w"] for res in ranks["ranks"])
        np.testing.assert_array_equal(a, b)


def test_default_momentum_and_branches():
    assert PB.BMUFConfig().resolved_momentum(4) == pytest.approx(0.75)
    assert PB.BMUFConfig(block_momentum=0.3).resolved_momentum(4) == pytest.approx(0.3)
    cfg = PB.BMUFConfig(**BMUF_CFG)
    assert [PB.branch(t, cfg) for t in range(1, 7)] == ["warmup_sync", "block_sync", "noop", "block_sync", "noop",
                                                        "block_sync"]


@pytest.mark.parametrize("model", ["acoustic", "t2s"])
def test_bmuf_steps_match_jax(ranks, model):
    jm, js = ranks["jax_steps"][model]
    train = js["train"]
    jparams, jema, jopt = train[0], train[2], train[1]
    if isinstance(jopt, (list, tuple)) and not hasattr(jopt, "mu"):
        jopt = next(s for s in jax.tree_util.tree_leaves(jopt, is_leaf=lambda x: hasattr(x, "mu"))
                    if hasattr(s, "mu"))
    cfg = PB.BMUFConfig(**BMUF_CFG)
    for res in ranks["ranks"]:
        got, r = res["steps"][model], res["rank"]
        for i, (s, m) in enumerate(zip(got["steps"], jm)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(s[k], m[k], rtol=LOSS_RTOL, err_msg=f"{model} step {i + 1} {k}")
            kind = PB.branch(i + 1, cfg)
            assert s["grad_syncs"] == 0 and s["syncs"] == (kind != "noop"), (i, s)
            assert s["sync_bytes"] == (got["param_bytes"] if kind != "noop" else 0)
        lrs = [s["lr"] for s in got["steps"]]
        if model == "t2s":      # the schedule at Adam's count: 0 at step 1, reset by the warmup, then 0, 1, 2, 3, 4
            sched = JLoop.reference_lr_schedule(JLoop.TrainConfig(lr=LR, use_lr_schedule=True, steps_per_epoch=1,
                                                                  wake_up_epochs=15))
            np.testing.assert_allclose(lrs, [float(sched(c)) for c in (0, 0, 1, 2, 3, 4)], rtol=1e-6)
        else:
            assert lrs == [LR] * STEPS
        assert got["count"] == int(np.asarray(jopt.count)[r]) == STEPS - 1
        assert (got["step"], got["ema_num_updates"]) == (STEPS, STEPS)
        far = total = 0
        for part, tree in (("params", jparams), ("ema", jema), ("mu", jopt.mu), ("nu", jopt.nu),
                           ("global", js["bmuf"]["global"]), ("smoothed", js["bmuf"]["smoothed"])):
            ref = {n: v[r] for n, v in named_leaves(tree)}
            assert got[part].keys() == ref.keys()
            for leaf, v in got[part].items():
                atol = PARAM_ATOL if part != "nu" else PARAM_ATOL * np.abs(ref[leaf]).max()
                np.testing.assert_allclose(v, ref[leaf], rtol=0, atol=atol, err_msg=f"{model} {part} {leaf}")
                if part == "params":
                    far += int(np.sum(np.abs(v - ref[leaf]) > PARAM_TIGHT))
                    total += v.size
        assert far <= PARAM_TIGHT_SHARE * total, (model, far, total)
    # after the last (sync) step the workers hold one model, bit for bit; JAX's too
    a, b = (res["steps"][model]["params"] for res in ranks["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert all(np.array_equal(v[0], v[1]) for _, v in named_leaves(jparams))


@pytest.mark.parametrize("name", list(REGULARIZERS))
def test_alignment_regularizer_one_device_matches_jax(name):
    case = REGULARIZERS[name]
    loss, gs, gt = _jax_regularizer(case, None)
    s = torch.tensor(case["source"], requires_grad=True)
    t = torch.tensor(case["target"], requires_grad=True)
    got = PC.alignment_regularizer(s, t, torch.from_numpy(case["source_mask"]), torch.from_numpy(case["target_mask"]),
                                   use_logsumexp_pool=case["pool"])
    got.backward()
    assert np.isfinite(got.item()) and abs(got.item() - float(loss)) <= REG_TOL * max(1.0, abs(float(loss)))
    np.testing.assert_allclose(s.grad.numpy(), gs, rtol=0, atol=REG_TOL)
    np.testing.assert_allclose(t.grad.numpy(), gt, rtol=0, atol=REG_TOL)
    assert PC.all_gather_batch(s, None) is s


@pytest.mark.parametrize("name", list(REGULARIZERS))
def test_alignment_regularizer_over_dp_matches_jax(ranks, name):
    """Each rank's loss is the one-device loss of the global batch, and its
    gradient (the backward of its copy of the loss through the gather, the
    cotangents reduce-scattered) dp times the one-device gradient of its
    rows, as JAX's under shard_map gives them."""
    loss1, gs1, gt1 = _jax_regularizer(REGULARIZERS[name], None)
    forms = [(np.full(DP, loss1), DP * gs1, DP * gt1)]
    if name in SHARD_MAP_NAN:
        assert not np.isfinite(_jax_regularizer(REGULARIZERS[name], "dp")[0]).all()
    else:
        forms.append(_jax_regularizer(REGULARIZERS[name], "dp"))
    for loss, gs, gt in forms:
        for res in ranks["ranks"]:
            got, r = res["regularizer"][name], res["rank"]
            assert abs(got["loss"] - float(loss[r])) <= REG_TOL * max(1.0, abs(float(loss[r])))
            rows = slice(r * 2, r * 2 + 2)
            np.testing.assert_allclose(got["source_grad"], gs[rows], rtol=0, atol=REG_TOL)
            np.testing.assert_allclose(got["target_grad"], gt[rows], rtol=0, atol=REG_TOL)
