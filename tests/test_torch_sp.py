"""The port's sequence parallelism (covomix_tpu_torch/parallel/ring.py, the
sp forms of mesh.py and train_step.py) against the JAX package, on the
CPU, with gloo ranks (`multihost.spawn`, tests/_torch_pp_child.py; one
spawn of two ranks, one of four):

* `ring_attention` at sp 2 and 4 against dense attention (the JAX
  package's `layers.attend`) on the gathered sequence, f32 to 2e-6 as JAX's
  own test holds its ring; one bf16 case (q, k, v rounded to bf16) within
  2^-8 max|v|: p is rounded to bf16 before the PV product (a relative
  2^-9 of each weight, the weights summing to 1 after the division) and
  the output once more (2^-9 of |out| <= max|v|);
* `conv1d_halo` against the SAME-padded grouped conv (atol 1e-5);
* `cfm_loss_sp` at (dp, sp) = (1, 2), (2, 2), (1, 4) with JAX's
  `cfm_inputs` draws, the shares added and averaged as the train step
  does: the loss and every gradient against JAX's `cfm_loss_sp` on the
  same mesh (JAX's tolerances: loss rtol 2e-5; gradients rtol 1e-4, atol
  5e-6), and each rank's ppermutes (sp - 1 hops a layer and two halos,
  forward and backward);
* `sample_sp` at cond_scale 1.0 and 0.7 on dp=1 x sp=2 against JAX's
  `sample_sp` with its y0 handed over as `noise` (atol 5e-4, JAX's test);
* the two ValueErrors of JAX's checks."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA, layers as JL
from covomix_tpu.parallel import ring as JR
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.parallel import ring as R
from covomix_tpu_torch.parallel.mesh import Mesh
from covomix_tpu_torch.util.misc import named_leaves

from _torch_port import port_cfg, to_port
from _torch_pp_child import run_ranks

CFG = JA.AcousticConfig(dim_in=8, dim=32, depth=4, dim_head=16, heads=2, ff_mult=2, num_phoneme_tokens=11,
                        dim_phoneme_emb=16, conv_pos_kernel=7)
P_CFG = port_cfg(PA.AcousticConfig, CFG)
DROP = 0.2
LOSS_CASES = {"dp1_sp2": (1, 2), "dp2_sp2": (2, 2), "dp1_sp4": (1, 4)}
RING_CASES = {"ring_sp2": (2, "float32"), "ring_sp4": (4, "float32"), "ring_sp2_bf16": (2, "bfloat16")}
SCALES = (1.0, 0.7)


def _params(seed=1):
    """JAX's init with the adaptive norms' projections made random."""
    rs = np.random.RandomState(seed)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(seed), CFG))


def _batch(b=4, t=32):
    r = np.random.RandomState(0)
    return (r.randn(b, t, CFG.mel_dim).astype(np.float32), r.randint(0, CFG.num_phoneme_tokens, (b, t)),
            r.randn(b, t, CFG.dim_in).astype(np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_mesh(dp, sp):
    return JR.make_sp_mesh(dp, sp, jax.devices()[:dp * sp])


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' cases run in two spawns while JAX computes its side."""
    params, batch = _params(), _batch()
    params_np = _np(params)
    key, skey = jax.random.PRNGKey(2), jax.random.PRNGKey(4)
    x1, ph, cond = (jnp.asarray(a) for a in batch)
    cfg_dict = dataclasses.asdict(P_CFG)
    inputs = tuple(None if a is None else np.array(a)
                   for a in JA.cfm_inputs(CFG, key, x1, cond, None, cond_drop_prob=DROP))
    noise = np.array(jax.random.normal(skey, (4, 32, CFG.mel_dim), jnp.float32))   # sample_sp's y0
    r = np.random.RandomState(1)
    qkv = [r.randn(2, 2, 32, 8).astype(np.float32) for _ in range(3)]
    conv = {"w": r.randn(7, 1, 16).astype(np.float32) * 0.1, "b": r.randn(16).astype(np.float32) * 0.1}
    xc = r.randn(2, 32, 16).astype(np.float32)
    cases = {2: {}, 4: {}}
    for name, (dp, sp) in LOSS_CASES.items():
        cases[dp * sp][name] = {"kind": "grads", "mesh": {"dp": dp, "sp": sp}, "cfg": cfg_dict, "params": params_np,
                                "batch": batch, "drop": DROP, "inputs": inputs}
    for name, (sp, dtype) in RING_CASES.items():
        cases[sp][name] = {"kind": "ring", "mesh": {"dp": 1, "sp": sp}, "qkv": qkv, "dtype": dtype}
    for sp in (2, 4):
        cases[sp][f"halo_sp{sp}"] = {"kind": "halo", "mesh": {"dp": 1, "sp": sp}, "p": conv, "x": xc, "kernel": 7}
    for scale in SCALES:
        cases[2][f"sample_{scale}"] = {"kind": "sample", "mesh": {"dp": 1, "sp": 2}, "cfg": cfg_dict,
                                       "params": params_np, "ph": batch[1], "cond": batch[2], "noise": noise,
                                       "cond_scale": scale}
    cases[2]["collectives"] = {"kind": "collectives", "mesh": {"dp": 1, "sp": 2}, "axis": "sp"}
    with ThreadPoolExecutor(2) as pool:
        spawns = {w: pool.submit(run_ranks, tmp_path_factory.mktemp(f"sp{w}"), c, w) for w, c in cases.items()}
        jax_res = {}
        with jax.default_matmul_precision("highest"):
            for name, (dp, sp) in LOSS_CASES.items():
                mesh = _jax_mesh(dp, sp)
                loss, grads = jax.jit(jax.value_and_grad(lambda p, mesh=mesh: JR.cfm_loss_sp(
                    p, CFG, key, x1, ph, cond, mesh=mesh, cond_drop_prob=DROP)))(params)
                jax_res[name] = (float(loss), {n: np.asarray(v) for n, v in named_leaves(grads)})
            for scale in SCALES:
                jax_res[f"sample_{scale}"] = np.array(jax.jit(lambda s=scale: JR.sample_sp(
                    params, CFG, skey, ph, cond, mesh=_jax_mesh(1, 2), cond_scale=s))())
        ranks = {w: f.result() for w, f in spawns.items()}
    return {"jax": jax_res, "ranks": ranks, "qkv": qkv, "conv": conv, "xc": xc}


def _ranks(run, name, world):
    return [r[name] for r in run["ranks"][world]]


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_dense(run, name):
    sp, dtype = RING_CASES[name]
    q, k, v = run["qkv"]
    if dtype == "bfloat16":
        q, k, v = (_bf16(a) for a in (q, k, v))
        atol = 2.0 ** -8 * float(np.abs(v).max())
    else:
        atol = 2e-6
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JL.attend(*(jnp.asarray(a) for a in (q, k, v))))
    for res in _ranks(run, name, sp):
        np.testing.assert_allclose(res["out"], want, rtol=0, atol=atol)


@pytest.mark.parametrize("sp", [2, 4])
def test_conv_halo_matches_same_padding(run, sp):
    p = {k: jnp.asarray(v) for k, v in run["conv"].items()}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JL.conv1d(p, jnp.asarray(run["xc"]), padding=3, groups=16))
    for res in _ranks(run, f"halo_sp{sp}", sp):
        np.testing.assert_allclose(res["out"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_sp_loss_and_grads_match_jax(run, name):
    dp, sp = LOSS_CASES[name]
    jloss, jgrads = run["jax"][name]
    for res in _ranks(run, name, dp * sp):
        np.testing.assert_allclose(res["loss"], jloss, rtol=2e-5)
        assert res["grads"].keys() == jgrads.keys()
        for leaf, g in jgrads.items():
            np.testing.assert_allclose(res["grads"][leaf], g, rtol=1e-4, atol=5e-6, err_msg=leaf)
        # depth x (sp - 1) K / V hops and the two halos, forward and backward; the row sums once
        assert res["ppermutes"] == 2 * (CFG.depth * (sp - 1) + 2) and res["axis_sums"] == 1


@pytest.mark.parametrize("scale", SCALES)
def test_sample_sp_matches_jax(run, scale):
    want = run["jax"][f"sample_{scale}"]
    for res in _ranks(run, f"sample_{scale}", 2):
        assert res["out"].shape == want.shape
        np.testing.assert_allclose(res["out"], want, rtol=0, atol=5e-4)
        # 16 midpoint steps of two field evaluations, each depth hops and two halos
        assert res["ppermutes"] == 16 * 2 * (CFG.depth + 2)


def test_sp_collectives_forward_and_backward(run):
    for res in _ranks(run, "collectives", 2):
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


@pytest.mark.parametrize("t,match", [(33, "not divisible by sp=2"), (4, "conv halo 3")])
def test_sp_checks_raise(t, match):
    """JAX's two checks, before any collective: T divides by sp, and each
    rank's frames cover the conv's halo."""
    params = to_port(_params())
    mesh = Mesh(1, 0, sp=2)
    r = np.random.RandomState(0)
    x1 = torch.from_numpy(r.randn(2, t, CFG.mel_dim).astype(np.float32))
    ph = torch.from_numpy(r.randint(0, 11, (2, t)))
    cond = torch.from_numpy(r.randn(2, t, CFG.dim_in).astype(np.float32))
    with pytest.raises(ValueError, match=match):
        R.cfm_loss_sp(params, P_CFG, torch.Generator().manual_seed(0), x1, ph, cond, mesh=mesh)
    with pytest.raises(ValueError, match=match):
        R.sample_sp(params, P_CFG, torch.Generator().manual_seed(0), ph, cond, mesh=mesh)
