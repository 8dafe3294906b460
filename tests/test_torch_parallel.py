"""The port's data parallelism (covomix_tpu_torch/parallel/) against the JAX
package's mesh step, on the CPU.

Two ranks over gloo (`multihost.spawn`, tests/_torch_dp_child.py) take one
data-parallel step of the tiny VoMix acoustic model and of the tiny CoMix
T2S model, each on its half of a global batch; the JAX side is
`make_sharded_train_step` on a 2-device mesh (the conftest's host devices)
with the same parameters and global batch. JAX's cfm_inputs are handed to
the port (the two packages draw different numbers). The T2S rows carry
targets of unequal lengths under a pad id, so the ranks' token counts
differ and only the global count gives JAX's loss. Also: the port's own
draws (every rank draws the global batch's and keeps its rows), the
process slice, `reconcile_batch`, `ProcessShardDataset` and `make_mesh`.

Tolerances: the loss and grad norm to 1e-5 relative (summation order
only, as tests/test_torch_acoustic_train.py's); the two ranks' parameters
bit for bit. A first Adam step moves an element by lr g / (|g| + 1e-8), so
an element whose gradient is near 1e-8 (the T2S case has one of 6.4e-9)
turns a 1e-8 difference of the gradient into a large share of lr: the
parameters after the step are held to 2 lr (the most two first updates can
differ by) and all but 0.1 % of the elements to 1e-2 lr."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA, text2semantic as JT
from covomix_tpu.parallel.mesh import make_mesh as jax_mesh
from covomix_tpu.parallel.train_step import init_sharded_state, make_sharded_train_step, shard_batch
from covomix_tpu.train import loop as JLoop
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT
from covomix_tpu_torch.parallel import multihost as MH
from covomix_tpu_torch.parallel.mesh import Mesh, make_mesh
from covomix_tpu_torch.util.misc import named_leaves

import _torch_dp_child
from _torch_port import J_AC, J_T2S, P_AC, jax_params, numpy_tree, port_cfg

B, T = 4, 64            # global rows; 2 a rank
LR = 1e-3
DROP = 0.3
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_TIGHT, PARAM_TIGHT_SHARE = 2 * LR, 1e-2 * LR, 1e-3
# the T2S targets padded with 500 (valid = not the pad id): rank 0's rows
# long, rank 1's short
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


def _t2s_batch(rs):
    sem = np.full((B, 48, 2), 500, np.int32)
    for i, n in enumerate(T2S_LENS):
        sem[i, :n] = rs.randint(0, 500, (n, 2))
    text = np.zeros((B, 16), np.int32)
    for i in range(B):
        text[i, :10 + i] = rs.randint(1, 199, 10 + i)
    return {"text_ids": text, "semantic_ids": sem}


def numpy_tree_jax(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_step(loss_fn, params, batch, key):
    """JAX's make_sharded_train_step on a 2-device dp mesh: (metrics, params)."""
    cfg = JLoop.TrainConfig(lr=LR)
    mesh = jax_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    with jax.default_matmul_precision("highest"), mesh:
        state, p_shard = init_sharded_state(params, cfg, mesh, tp=False)
        step = make_sharded_train_step(loss_fn, cfg, mesh, p_shard)
        new, m = step(state, shard_batch(mesh, jax.tree_util.tree_map(jnp.asarray, batch)), key)
        return {k: float(v) for k, v in m.items()}, dict(named_leaves(jax.device_get(new.params)))


def _own_draw_case(rs):
    """Inputs for the port-only check of the draws: a tiny acoustic model
    with cond-drop and no batch mask, a tiny T2S with classifier-free
    guidance (the cond-drop row draw)."""
    g = torch.Generator().manual_seed(3)
    t2s_cfg = dataclasses.replace(port_cfg(PT.T2SConfig, J_T2S_PAD), classifier_free_guidance=True,
                                  cond_drop_prob=0.5)
    case = {"x1": rs.randn(B, T, 80).astype(np.float32), "cond": rs.randn(B, T, 160).astype(np.float32),
            "phonemes": rs.randint(0, 502, (B, T, 2)).astype(np.int32),
            "ac": {"cfg": dataclasses.asdict(P_AC), "params": numpy_tree(PA.init(g, P_AC))},
            "t2s": {"cfg": dataclasses.asdict(t2s_cfg), "params": numpy_tree(PT.init(g, t2s_cfg))}}
    case.update(_t2s_batch(rs))
    return case


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's mesh steps, then the port's two ranks on the same inputs."""
    path = str(tmp_path_factory.mktemp("dp"))
    rs = np.random.RandomState(0)
    key = jax.random.PRNGKey(7)
    ac_params, ac_batch = _acoustic_params(), _acoustic_batch(rs)
    x = jnp.asarray(ac_batch["x"])
    with jax.default_matmul_precision("highest"):
        inputs = JA.cfm_inputs(J_AC, key, x[..., -80:], x[..., :-80], jnp.asarray(ac_batch["mask"]),
                               cond_drop_prob=DROP)
    t2s_params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(4), J_T2S_PAD)
    t2s_batch = _t2s_batch(rs)
    # numpy copies first: the JAX step donates the state it is given
    ac_np, t2s_np = numpy_tree_jax(ac_params), numpy_tree_jax(t2s_params)
    jax_results = {
        "acoustic": _jax_step(JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP), ac_params, ac_batch, key),
        "t2s": _jax_step(JLoop.t2s_loss_fn(J_T2S_PAD), t2s_params, t2s_batch, key)}
    train_cfg = {"lr": LR}
    steps = {
        "acoustic": {"model": "acoustic", "cfg": dataclasses.asdict(P_AC), "params": ac_np,
                     "batch": ac_batch, "inputs": tuple(None if a is None else np.array(a) for a in inputs),
                     "drop": DROP, "train_cfg": train_cfg},
        "t2s": {"model": "t2s", "cfg": dataclasses.asdict(port_cfg(PT.T2SConfig, J_T2S_PAD)),
                "params": t2s_np, "batch": t2s_batch, "train_cfg": train_cfg}}
    own = _own_draw_case(rs)
    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump({"steps": steps, "own_draws": own}, f)
    MH.spawn(_torch_dp_child.train_steps, 2, path, device="cpu")
    ranks = []
    for r in range(2):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"jax": jax_results, "ranks": ranks, "own": own}


@pytest.mark.parametrize("model", ["acoustic", "t2s"])
def test_dp_step_matches_jax_mesh_step(run, model):
    """Loss and grad norm of the rank-averaged step against JAX's mesh step;
    the updated parameters as the module docstring says."""
    (jm, jparams), ranks = run["jax"][model], run["ranks"]
    for res in ranks:
        got = res[model]
        assert got["syncs"] == 1     # one flat all-reduce of the gradients and the loss
        np.testing.assert_allclose(got["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"], rtol=LOSS_RTOL)
        assert got["params"].keys() == jparams.keys()
        far = total = 0
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, jparams[name], rtol=0, atol=PARAM_ATOL, err_msg=name)
            far += int(np.sum(np.abs(p - jparams[name]) > PARAM_TIGHT))
            total += p.size
        assert far <= PARAM_TIGHT_SHARE * total, (far, total)


@pytest.mark.parametrize("model", ["acoustic", "t2s"])
def test_ranks_end_with_bit_equal_params(run, model):
    a, b = (r[model] for r in run["ranks"])
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for name, p in a["params"].items():
        np.testing.assert_array_equal(p, b["params"][name], err_msg=name)


def test_t2s_token_counts_differ_across_ranks():
    """The case above is one where a per-rank mean is not the global loss."""
    half = len(T2S_LENS) // 2
    assert sum(T2S_LENS[:half]) != sum(T2S_LENS[half:])


def test_own_draws_are_the_global_batchs(run):
    """Each rank draws for the global batch from a generator seeded alike and
    keeps its rows: the ranks' mean loss is the one-device loss with the same
    seed (acoustic: training mask, noise, times, cond-drop; T2S: cond-drop
    rows, with the global token count)."""
    own = run["own"]
    ac_cfg, t2s_cfg = PA.AcousticConfig(**own["ac"]["cfg"]), PT.T2SConfig(**own["t2s"]["cfg"])
    t = {k: torch.from_numpy(own[k]) for k in ("x1", "cond", "phonemes", "text_ids", "semantic_ids")}
    with torch.no_grad():
        ac = PA.cfm_loss(params_from_numpy(own["ac"]["params"], "cpu"), ac_cfg, torch.Generator().manual_seed(5),
                         t["x1"], t["phonemes"], t["cond"], cond_drop_prob=0.5).item()
        t2s = PT.forward_loss(params_from_numpy(own["t2s"]["params"], "cpu"), t2s_cfg, t["text_ids"],
                              t["semantic_ids"], generator=torch.Generator().manual_seed(6), cond_drop=True).item()
    for name, ref in (("acoustic", ac), ("t2s", t2s)):
        mean = sum(r["own_draws"][name] for r in run["ranks"]) / 2
        np.testing.assert_allclose(mean, ref, rtol=LOSS_RTOL, err_msg=name)


def test_process_group_view(run):
    """Rank r of 2: its slice of a global batch of 8, rank 0 alone primary."""
    for r, res in enumerate(run["ranks"]):
        assert (res["rank"], res["dp"], res["primary"]) == (r, 2, r == 0)
        assert (res["slice"].start, res["slice"].stop) == (4 * r, 4 * r + 4)
    s = MH.process_batch_slice(8)       # no process group here: the whole batch
    assert (s.start, s.stop) == (0, 8) and MH.is_primary()


def test_reconcile_batch_pads_to_the_ranks_max(run):
    """Each leaf padded to the cross-rank max of every trailing dim with its
    key's training pad (mel -15, mask False, codes 501, text 0)."""
    want = {"x": (2, 16, 3), "mask": (2, 16), "semantic_ids": (2, 7, 2), "text_ids": (2, 5), "durations": (2,)}
    for r, res in enumerate(run["ranks"]):
        got = res["reconcile"]
        assert {k: v.shape for k, v in got.items()} == want
    r0, r1 = (res["reconcile"] for res in run["ranks"])
    assert (r0["x"][:, 10:] == -15.0).all() and (r0["x"][:, :10] == 1).all()
    assert not r0["mask"][:, 10:].any() and r0["mask"][:, :10].all()
    assert (r0["semantic_ids"][:, 4:] == 501).all() and (r0["semantic_ids"][:, :4] == 7).all()
    assert (r1["text_ids"][:, 3:] == 0).all() and (r1["text_ids"][:, :3] == 9).all()
    assert (r1["x"] == 1).all() and (r0["text_ids"] == 9).all()


def test_process_shard_dataset_strides_and_floors():
    data = list(range(10))
    shards = [MH.ProcessShardDataset(data, index=i, count=3) for i in range(3)]
    assert [len(s) for s in shards] == [3, 3, 3]          # the floor on every rank
    assert [[s[i] for i in range(3)] for s in shards] == [[0, 3, 6], [1, 4, 7], [2, 5, 8]]
    one = MH.ProcessShardDataset(data)                      # no process group: the identity
    assert len(one) == 10 and [one[i] for i in range(10)] == data


def test_shard_batch_takes_the_ranks_rows():
    """Axis 0 of a batch, axis 1 of grad accumulation's [A, B, ...] leaves;
    a batch that does not divide by dp raises."""
    from covomix_tpu_torch.parallel.train_step import shard_batch as port_shard_batch

    x = np.arange(2 * 4 * 3).reshape(2, 4, 3)
    mesh = Mesh(2, 1)
    np.testing.assert_array_equal(port_shard_batch(mesh, {"x": x[0]})["x"], x[0, 2:])
    np.testing.assert_array_equal(port_shard_batch(mesh, {"x": x}, accum=True)["x"], x[:, 2:])
    with pytest.raises(ValueError, match="does not divide by dp=2"):
        port_shard_batch(mesh, {"x": x[0, :3]})


def test_make_mesh_resolves_the_world(capsys):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="more than the 2 available devices"):
        make_mesh(3, "cpu", devices=[cpu, cpu])
    assert make_mesh(0, "cpu") == Mesh(1, 0, cpu)           # --dp 0 on the CPU: the one device
    assert make_mesh(0, "cpu", devices=[cpu] * 3).dp == 3
    assert make_mesh(2, "cpu").dp == 2                      # the CPU stands for as many as asked
    assert make_mesh(1, "cpu", devices=[cpu, cpu]).dp == 1
    assert "uses 1 of 2 available devices" in capsys.readouterr().out
    m = Mesh(4, 2)
    assert (m.rows(3).start, m.rows(3).stop) == (6, 9) and not m.collective
