"""The port's pipeline parallelism (covomix_tpu_torch/parallel/pipeline.py,
collectives.py, the pp forms of mesh.py and train_step.py) against the JAX
package, on the CPU.

* `stack_layer_params` / `unstack_layer_params` equal JAX's bit for bit,
  `pp_param_shardings` gives JAX's specs (the tiny config and the VoMix
  recipe's full width, by shape), and `params_from_numpy` carries a JAX
  stacked tree to the port's stacking of the carried canonical tree; a
  train state of one layout does not resume into the other (ValueError).
* Gloo ranks (`multihost.spawn`, tests/_torch_pp_child.py; one spawn of two
  ranks, one of four) run `pp_cfm_loss` at (dp, pp, M) = (1, 2, 4), (1, 2,
  2) and (2, 2, 4) with JAX's `cfm_inputs` draws, the shares added and
  averaged as the train step does: the loss and every gradient against
  JAX's `pp_cfm_loss` on the same mesh of the conftest's host devices at
  JAX's own tolerances (tests/test_pipeline_parallel.py: loss rtol 2e-5,
  gradients rtol 1e-4, atol 5e-6); the first-half skip placeholders'
  gradients exactly 0 on every rank.
* Three train steps on dp=2 x pp=2 against JAX's `make_sharded_train_step`
  on its pp mesh (each step's draws from its key): losses to 5e-5 (the
  JAX test's bound against one device), the parameters within 2 x 1.0055
  lr a step, all but 0.1 % of the elements within 1e-2 lr; the replicated
  `rest` bit-equal over the pp ranks, each stage holding depth / pp layers.
* The ppermute moves rank-valued tensors by +1 / -1 and sends the
  gradients back; a step makes 2 (M + pp - 2) of them."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA
from covomix_tpu.parallel import pipeline as JPP
from covomix_tpu.parallel.train_step import make_sharded_train_step
from covomix_tpu.train import loop as JLoop
from covomix_tpu_torch.checkpoint.io import load_train_state, params_from_numpy, save_train_state
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.parallel import pipeline as PP
from covomix_tpu_torch.parallel.mesh import Mesh
from covomix_tpu_torch.train import loop as PLoop
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves

from _torch_port import port_cfg, to_port
from _torch_pp_child import run_ranks

CFG = JA.AcousticConfig(dim_in=8, dim=32, depth=4, dim_head=16, heads=2, ff_mult=2, num_phoneme_tokens=11,
                        dim_phoneme_emb=16, conv_pos_kernel=7)
P_CFG = port_cfg(PA.AcousticConfig, CFG)
VOMIX = JA.AcousticConfig(dim_in=160, dim=1024, depth=8, dim_head=64, heads=16, num_phoneme_tokens=502,
                          mode="two_one")
DROP = 0.2
LR = 1e-3
TRAIN_STEPS = 3
GRAD_CASES = {"dp1_pp2_m4": (1, 2, 4), "dp1_pp2_m2": (1, 2, 2), "dp2_pp2_m4": (2, 2, 4)}


def _params(seed=1):
    """JAX's init with the adaptive norms' projections made random (zero at
    init, they would leave the time embedding untrained)."""
    rs = np.random.RandomState(seed)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(seed), CFG))


def _batch(b=8, t=24):
    r = np.random.RandomState(0)
    return (r.randn(b, t, CFG.mel_dim).astype(np.float32), r.randint(0, CFG.num_phoneme_tokens, (b, t)),
            r.randn(b, t, CFG.dim_in).astype(np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _inputs(key, batch):
    x1, _, cond = (jnp.asarray(a) for a in batch)
    drawn = JA.cfm_inputs(CFG, key, x1, cond, None, cond_drop_prob=DROP)
    return tuple(None if a is None else np.array(a) for a in drawn)


def _jax_mesh(dp, pp):
    return JPP.make_pp_mesh(dp, pp, jax.devices()[:dp * pp])


def _stacked_named(tree) -> dict:
    return {n: np.asarray(v) for n, v in named_leaves(tree)}


def test_stack_unstack_equal_jax():
    params = _params()
    js, jr = JPP.stack_layer_params(params, CFG)
    ps, pr = PP.stack_layer_params(to_port(params), P_CFG)
    want = _stacked_named({"stacked": js, "rest": jr})
    got = {n: t.numpy() for n, t in named_leaves({"stacked": ps, "rest": pr})}
    assert got.keys() == want.keys()
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    back = {n: t.numpy() for n, t in named_leaves(PP.unstack_layer_params(ps, pr, P_CFG))}
    canon = _stacked_named(JPP.unstack_layer_params(js, jr, CFG))
    assert back.keys() == canon.keys() == _stacked_named(params).keys()
    for n, v in canon.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)


@pytest.mark.parametrize("cfg", [CFG, VOMIX], ids=["tiny", "vomix"])
def test_pp_param_shardings_equal_jax(cfg):
    shapes = jax.eval_shape(lambda k: dict(zip(("stacked", "rest"), JPP.stack_layer_params(JA.init(k, cfg), cfg))),
                            jax.random.PRNGKey(0))
    sh = JPP.pp_param_shardings(_jax_mesh(2, 2), shapes)
    ndim = {path: len(leaf.shape) for path, leaf in named_leaves(shapes)}
    want = {path: tuple(s.spec) + (None,) * (ndim[path] - len(s.spec)) for path, s in named_leaves(sh)}
    got = PP.pp_param_shardings(Mesh(2, 0, pp=2), shapes)
    assert got == want
    assert got["stacked/qkv/w"] == ("pp", None, None) and got["rest/to_embed/w"] == (None, None)


def test_params_from_numpy_carries_a_jax_stacked_tree():
    params = _params()
    js, jr = JPP.stack_layer_params(params, CFG)
    carried = params_from_numpy(_np({"stacked": js, "rest": jr}), "cpu")
    ps, pr = PP.stack_layer_params(params_from_numpy(_np(params), "cpu"), P_CFG)
    got = dict(named_leaves(carried))
    want = dict(named_leaves({"stacked": ps, "rest": pr}))
    assert got.keys() == want.keys()
    for n, t in want.items():
        assert got[n].dtype == t.dtype and np.array_equal(got[n].numpy().view(np.int32), t.numpy().view(np.int32)), n


@pytest.mark.parametrize("saved", ["stacked", "canonical"])
def test_resume_across_layouts_raises(tmp_path, saved):
    """A --pp train state does not load into a canonical one, nor the
    reverse: ValueError naming both layouts (no KeyError half-way)."""
    canon = params_from_numpy(_np(_params()), "cpu")
    stacked = dict(zip(("stacked", "rest"), PP.stack_layer_params(canon, P_CFG)))
    trees = {"stacked": stacked, "canonical": canon}
    save_train_state(str(tmp_path), PLoop.init_train_state(trees[saved], PLoop.TrainConfig()), 3)
    other = PLoop.init_train_state(trees["canonical" if saved == "stacked" else "stacked"], PLoop.TrainConfig())
    before = [t.detach().clone() for t in tree_leaves(other.params)]
    with pytest.raises(ValueError, match=r"pipeline \{'stacked', 'rest'\} layout.*canonical layout"
                       if saved == "stacked" else r"canonical layout.*pipeline \{'stacked', 'rest'\} layout"):
        load_train_state(str(tmp_path), 3, other)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(other.params)))   # left as it was
    assert load_train_state(str(tmp_path), 3, PLoop.init_train_state(trees[saved], PLoop.TrainConfig())).step == 0


def _case(kind, dp, params, batch, **extra):
    return {"kind": kind, "mesh": {"dp": dp, "pp": 2}, "cfg": dataclasses.asdict(P_CFG), "params": params,
            "batch": batch, "drop": DROP, **extra}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' cases run in two spawns while JAX computes its side."""
    params, batch = _params(), _batch()
    params_np = _np(params)          # the JAX step donates its state, which may alias these buffers
    key = jax.random.PRNGKey(2)
    keys = [jax.random.PRNGKey(100 + i) for i in range(TRAIN_STEPS)]
    inputs = _inputs(key, batch)
    cases2 = {name: _case("grads", dp, params_np, batch, m=m, inputs=inputs)
              for name, (dp, _, m) in GRAD_CASES.items() if dp == 1}
    cases2["collectives"] = {"kind": "collectives", "mesh": {"dp": 1, "pp": 2}, "axis": "pp"}
    cases4 = {name: _case("grads", dp, params_np, batch, m=m, inputs=inputs)
              for name, (dp, _, m) in GRAD_CASES.items() if dp == 2}
    cases4["train"] = _case("train", 2, params_np, batch, m=4, lr=LR,
                            step_inputs=[_inputs(k, batch) for k in keys])
    x1, ph, cond = (jnp.asarray(a) for a in batch)
    with ThreadPoolExecutor(2) as pool:
        spawns = {w: pool.submit(run_ranks, tmp_path_factory.mktemp(f"pp{w}"), c, w)
                  for w, c in ((2, cases2), (4, cases4))}
        jax_grads = {}
        with jax.default_matmul_precision("highest"):
            for name, (dp, pp, m) in GRAD_CASES.items():
                mesh = _jax_mesh(dp, pp)
                pp_params = dict(zip(("stacked", "rest"), JPP.stack_layer_params(params, CFG)))
                pp_params = jax.tree.map(jax.device_put, pp_params, JPP.pp_param_shardings(mesh, pp_params))
                loss, grads = jax.jit(jax.value_and_grad(lambda p, mesh=mesh, m=m: JPP.pp_cfm_loss(
                    p, CFG, key, x1, ph, cond, mesh=mesh, num_microbatches=m, cond_drop_prob=DROP)))(pp_params)
                jax_grads[name] = (float(loss), _stacked_named(grads))
            # three train steps on dp=2 x pp=2, as tests/test_pipeline_parallel.py takes them
            mesh = _jax_mesh(2, 2)
            tcfg = JLoop.TrainConfig(lr=LR)
            pp_params = dict(zip(("stacked", "rest"), JPP.stack_layer_params(params, CFG)))
            shardings = JPP.pp_param_shardings(mesh, pp_params)
            state = JLoop.init_train_state(jax.tree.map(lambda a, sh: jax.device_put(jnp.array(a), sh), pp_params,
                                                        shardings), tcfg)
            step = make_sharded_train_step(lambda p, b, k: JPP.pp_cfm_loss(
                p, CFG, k, b[0], b[1], b[2], mesh=mesh, num_microbatches=4, cond_drop_prob=DROP), tcfg, mesh,
                shardings)
            losses = []
            for k in keys:
                state, m = step(state, (x1, ph, cond), k)
                losses.append({n: float(v) for n, v in m.items()})
            jax_train = (losses, _stacked_named(jax.device_get(state.params)))
        ranks = {w: f.result() for w, f in spawns.items()}
    return {"grads": jax_grads, "train": jax_train, "ranks": ranks}


def _ranks(run, name):
    dp = GRAD_CASES[name][0] if name in GRAD_CASES else 2
    return [r[name] for r in run["ranks"][2 * dp]]


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_pp_loss_and_grads_match_jax(run, name):
    jloss, jgrads = run["grads"][name]
    for res in _ranks(run, name):
        np.testing.assert_allclose(res["loss"], jloss, rtol=2e-5)
        assert res["grads"].keys() == jgrads.keys()
        for leaf, g in jgrads.items():
            np.testing.assert_allclose(res["grads"][leaf], g, rtol=1e-4, atol=5e-6, err_msg=leaf)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_first_half_skip_grads_are_exactly_zero(run, name):
    """Before and after the shares are added: each rank's own first-half
    placeholders, and the gathered tree's."""
    ranks = _ranks(run, name)
    seen = set()
    for res in ranks:
        seen |= set(res["skip"])
        assert all(v == 0.0 for v in res["skip"].values()), res["skip"]
        for k in ("w", "b"):
            assert not np.any(res["grads"][f"stacked/skip/{k}"][: CFG.depth // 2])
    assert seen == set(range(CFG.depth // 2))


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_pp_ppermutes_per_step(run, name):
    """M + pp - 2 ticks send the carry on, and each send comes back in the
    backward; the loss is summed over pp once."""
    _, pp, m = GRAD_CASES[name]
    for res in _ranks(run, name):
        assert res["ppermutes"] == PP.ppermutes_per_step(m, pp) == 2 * (m + pp - 2)
        assert res["axis_sums"] == 1


def test_pp_train_steps_match_jax(run):
    jlosses, jparams = run["train"]
    ranks = _ranks(run, "train")
    lr = LR
    for res in ranks:
        for got, want in zip(res["metrics"], jlosses):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=5e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=5e-5)
        far = total = 0
        assert res["params"].keys() == jparams.keys()
        for leaf, v in jparams.items():
            np.testing.assert_allclose(res["params"][leaf], v, rtol=0, atol=2 * 1.0055 * lr * TRAIN_STEPS,
                                       err_msg=leaf)
            far += int(np.sum(np.abs(res["params"][leaf] - v) > 1e-2 * lr))
            total += v.size
        assert far <= 1e-3 * total, (far, total)


def test_pp_state_lives_on_the_stages(run):
    """Each rank holds depth / pp layers of every stacked leaf (parameters
    and EMA); the replicated rest is bit-equal on the two pp ranks of a dp
    index and on the two dp ranks of a stage."""
    ranks = _ranks(run, "train")
    specs = ranks[0]["specs"]
    for res in ranks:
        for leaf, spec in specs.items():
            want = res["params"][leaf].shape
            if spec[0] == "pp":
                want = (want[0] // 2,) + want[1:]
            assert res["local"][leaf].shape == res["ema"][leaf].shape == want, leaf
    for a in ranks:
        for b in ranks:
            for leaf, spec in specs.items():
                if spec[0] != "pp" or a["index"] == b["index"]:
                    np.testing.assert_array_equal(a["local"][leaf], b["local"][leaf], err_msg=leaf)
                    np.testing.assert_array_equal(a["ema"][leaf], b["ema"][leaf], err_msg=leaf)


def test_ppermute_forward_and_backward(run):
    """Rank i holds tensors of i + 1: by +1 each receives its predecessor's,
    by -1 its successor's (n = 2: the other rank's either way), and each
    gets back the gradient its receiver applied (the receiver's r and 2r);
    axis_sum adds forward and passes the gradient through."""
    for res in [r["collectives"] for r in run["ranks"][2]]:
        r = res["index"] + 1.0
        other = 3.0 - r
        assert res["backend"] == "gloo"
        for dt in ("torch.float32", "torch.bfloat16"):
            for shift in (1, -1):
                ya, yb, ga, gb = res[f"ppermute_{dt}_{shift}"]
                assert (ya == other).all() and (yb == 10 * other).all()
                assert (ga == other).all() and (gb == 2 * other).all()
        y, g = res["axis_sum"]
        assert (y == 3).all() and (g == r).all()
