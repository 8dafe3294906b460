"""The port's tensor parallelism (covomix_tpu_torch/parallel/mesh.py,
tensor.py, train_step.py) against the JAX package, on the CPU.

* `param_shardings`: the port's spec of every leaf equals JAX's
  `param_shardings(...).spec`, for both tiny models on dp=2 x tp=2 and
  dp=4 x tp=2 meshes of the conftest's host devices, with and without
  fsdp, and for the recipes' full-width configs by shape alone
  (`jax.eval_shape`). These carry the mixed cases: the odd-row phoneme and
  text tables stay replicated, `sem_emb` (502 rows) splits, the source
  FFN's `w1` splits while its `w2` (85 / 1365 rows) does not.
* Two ranks over gloo (tp=2, `multihost.spawn`, tests/_torch_tp_child.py)
  take one step of the tiny VoMix and CoMix T2S models, a T2S step over 2
  micro-batches and one of a 3-head T2S (the gather form), held against JAX's `make_sharded_train_step` on a
  1 x 2 mesh with the same parameters, global batch and draws
  (tests/_torch_tp_cases.py states the tolerances).
* Both ranks hold every replicated leaf bit for bit; `gather_params`
  undoes `shard_params` bit for bit; the tp collectives' forward and
  backward; the process slices follow the dp index."""

import jax
import numpy as np
import pytest

from covomix_tpu.models import acoustic as JA, text2semantic as JT
from covomix_tpu.parallel.mesh import make_mesh as jax_mesh, param_shardings as jax_shardings
from covomix_tpu_torch.parallel.mesh import Mesh, param_shardings
from covomix_tpu_torch.util.misc import named_leaves

from _torch_port import J_AC, J_T2S
from _torch_tp_cases import cases, check_against_jax, check_replicas, run_ranks

# the recipes at full width (running_command/Acous_VoMix.sh, T2S_CoMix.sh; chip_smoke.py's flags)
VOMIX = JA.AcousticConfig(dim_in=160, dim=1024, depth=8, dim_head=64, heads=16, num_phoneme_tokens=502,
                          mode="two_one")
COMIX = JT.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, num_text_tokens=30528,
                     num_semantic_tokens=501, target_dim=1024, two_output=True)
MODELS = {"acoustic": (JA.init, J_AC), "t2s": (JT.init, J_T2S), "vomix": (JA.init, VOMIX),
          "comix": (JT.init, COMIX)}


def _jax_specs(model, dp, tp, fsdp):
    """(shape tree, {path: JAX's spec as a tuple}) of a model's parameters."""
    init, cfg = MODELS[model]
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    mesh = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    sh = jax_shardings(mesh, shapes, tp=True, fsdp=fsdp)
    return shapes, {path: tuple(s.spec) + (None,) * (len(leaf.shape) - len(s.spec))
                    for (path, s), (_, leaf) in zip(named_leaves(sh), named_leaves(shapes))}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("model", ["acoustic", "t2s"])
def test_param_shardings_equal_jax(model, dp, fsdp):
    shapes, want = _jax_specs(model, dp, 2, fsdp)
    got = param_shardings(Mesh(dp, 0, tp=2), shapes, fsdp=fsdp)
    assert got == want
    assert any("tp" in s for s in got.values()) and (not fsdp or any("dp" in s for s in got.values()))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("model", ["vomix", "comix"])
def test_param_shardings_equal_jax_at_full_width(model, fsdp):
    shapes, want = _jax_specs(model, 4, 2, fsdp)
    assert param_shardings(Mesh(4, 0, tp=2), shapes, fsdp=fsdp) == want


def test_mixed_specs_at_tiny_and_full_width():
    """The cases the issue of mixed specs names, at both sizes."""
    for model in ("t2s", "comix"):
        _, specs = _jax_specs(model, 2, 2, False)
        assert specs["text_emb/w"] == (None, None) and specs["sem_emb/w"] == ("tp", None)
        assert specs["source_layers/0/ff/w1/w"] == (None, "tp") and specs["source_layers/0/ff/w2/w"] == (None, None)
        assert specs["target_layers/0/ff/w2/w"] == ("tp", None)
    for model in ("acoustic", "vomix"):
        _, specs = _jax_specs(model, 2, 2, False)
        assert specs["phoneme_emb/w"] == (None, None) and specs["time_mlp/w"] == (None, "tp")
        assert specs["layers/0/attn_norm/to_gamma/w"] == (None, None)


NAMES = ["acoustic", "t2s", "t2s_accum2", "t2s_heads3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jax_results, port = cases(("acoustic", "t2s", "t2s_heads3"), 1, 2, False, accum_t2s=True)
    return {"jax": jax_results, "ranks": run_ranks(tmp_path_factory.mktemp("tp"), port, 1, 2, False)}


@pytest.mark.parametrize("name", NAMES)
def test_tp_step_matches_jax_mesh_step(run, name):
    check_against_jax(run["jax"][name], run["ranks"], name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_bit_equal_across_tp_ranks(run, name):
    assert check_replicas(run["ranks"], name) > 0


@pytest.mark.parametrize("name", NAMES)
def test_tp_state_lives_on_the_shards(run, name):
    """Each rank holds half of every tp-split leaf (its parameters and EMA),
    and the step ran its collectives: no gradient all-reduce over a dp of 1,
    one for the sharded norm."""
    for res in run["ranks"]:
        got = res[name]
        for leaf, spec in got["specs"].items():
            full = got["params"][leaf].shape
            want = tuple(n // 2 if s == "tp" else n for n, s in zip(full, spec))
            assert got["local"][leaf].shape == got["ema"][leaf].shape == want, leaf
        assert got["grad_syncs"] == 1 and got["param_gathers"] == 0
        assert got["tp_collectives"] > 0


def test_tp_collective_counts_per_step(run):
    """The tp collectives of one step, by block (forward + backward). The
    tiny VoMix (2 layers): each attention and FFN block's copy_to_tp
    (all-reduce backward) and reduce_from_tp (all-reduce forward), 2 x 2 x
    2, and the time MLP's gather and copy, 2: 10. The tiny CoMix T2S (1 + 1
    layers, two logit heads): the source attention's copy and reduce, 2;
    the source FFN's 85 pairs do not split over 2, so its split w1 and bias
    are gathered, 2; the target self-attention 2, the cross-attention's
    context, query and null-KV copies and its reduce, 4, the FFN's copy and
    reduce, 2; the sem_emb gather of the lookup, 1; each logit head's copy
    and gather, 4: 17, and twice that over 2 micro-batches. With 3 heads
    the attention leaves are gathered instead (their gradients are slices,
    no collective): source q, kv, out 3 and the FFN's 2, target
    self-attention 3, cross-attention 3 (kv, q, out), its FFN 2, the lookup
    1 and the logits 4: 18."""
    counts = {n: run["ranks"][0][n]["tp_collectives"] for n in NAMES}
    assert counts == {"acoustic": 10, "t2s": 17, "t2s_accum2": 34, "t2s_heads3": 18}


def test_shard_gather_round_trip_is_exact(run):
    for res in run["ranks"]:
        assert all(res["roundtrip"].values()), res["roundtrip"]


def test_tp_collectives_forward_and_backward(run):
    """Ranks r = 1, 2 hold tensors of r: copy_to_tp is the identity forward
    and sums the gradients r over tp backward (3); reduce_from_tp sums
    forward (3) and passes the gradient through; gather_from_tp concatenates
    forward and gives each rank its slice of the gradient."""
    for res in run["ranks"]:
        c, r = res["collectives"], res["tp_rank"] + 1.0
        assert c["backend"] == "gloo"
        for dt in ("torch.float32", "torch.bfloat16"):
            y, g = c[f"copy_{dt}"]
            assert (y == r).all() and (g == 3).all()
            y, g = c[f"reduce_{dt}"]
            assert (y == 3).all() and (g == r).all()
            y, g = c[f"gather_{dt}"]
            assert (y[:, :3] == 1).all() and (y[:, 3:] == 2).all()
            np.testing.assert_array_equal(g, np.tile(np.arange(3 * (r - 1), 3 * r), (2, 1)))


def test_tp_ranks_load_their_dp_index_rows(run):
    """At dp=1 both tp ranks load the whole batch and every item."""
    for res in run["ranks"]:
        assert res["slices"] == ((0, 8), list(range(10)))
