"""The port's FSDP (`--fsdp`: parameters, Adam moments and EMA split over
dp; parallel/train_step.py) against the JAX package, on the CPU.

The tiny VoMix and CoMix T2S models take one step on dp=2 with fsdp (two
ranks over gloo) and on dp=2 x tp=2 with fsdp (four ranks), held against
JAX's `make_sharded_train_step` on a 2 x 1 and a 2 x 2 mesh of the
conftest's host devices with the same parameters, global batch and draws
(tests/_torch_tp_cases.py states the tolerances). Every part of the state
that two ranks both hold is bit-equal on both; each rank holds its part
of the leaves split over dp; the step gathers the parameters once and
reduce-scatters their gradients once; the ranks load the rows of their dp
index."""

import numpy as np
import pytest

from _torch_tp_cases import cases, check_against_jax, check_replicas, run_ranks

MESHES = {"dp2": (2, 1), "dp2_tp2": (2, 2)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def run(request, tmp_path_factory):
    dp, tp = MESHES[request.param]
    jax_results, port = cases(("acoustic", "t2s"), dp, tp, True)
    return {"jax": jax_results, "ranks": run_ranks(tmp_path_factory.mktemp(request.param), port, dp, tp, True),
            "dp": dp, "tp": tp}


@pytest.mark.parametrize("name", ["acoustic", "t2s"])
def test_fsdp_step_matches_jax_mesh_step(run, name):
    check_against_jax(run["jax"][name], run["ranks"], name)


@pytest.mark.parametrize("name", ["acoustic", "t2s"])
def test_parts_held_twice_are_bit_equal(run, name):
    """At dp=2 every leaf of both tiny models splits over dp, so only the
    loss and grad norm are held twice; at dp=2 x tp=2 the tp ranks of one
    dp index share the leaves not split over tp."""
    held_twice = check_replicas(run["ranks"], name)
    assert held_twice > 0 if run["tp"] > 1 else held_twice == 0


@pytest.mark.parametrize("name", ["acoustic", "t2s"])
def test_fsdp_state_lives_on_the_shards(run, name):
    """Each rank's parameters and EMA are its block of every split axis
    (dp and tp); one parameter all-gather and three gradient collectives a
    step (the all-reduce of the loss and any leaf not split over dp, the
    reduce-scatter, the sharded norm); tp's collectives only with tp."""
    dp, tp = run["dp"], run["tp"]
    for res in run["ranks"]:
        got = res[name]
        assert any("dp" in s for s in got["specs"].values())
        for leaf, spec in got["specs"].items():
            full = got["params"][leaf].shape
            want = tuple(n // {"dp": dp, "tp": tp}.get(s, 1) for n, s in zip(full, spec))
            assert got["local"][leaf].shape == got["ema"][leaf].shape == want, leaf
        assert (got["param_gathers"], got["grad_syncs"]) == (1, 3)
        assert (got["tp_collectives"] > 0) == (tp > 1)


def test_shard_gather_round_trip_is_exact(run):
    for res in run["ranks"]:
        assert all(res["roundtrip"].values()), res["roundtrip"]


def test_ranks_load_their_dp_index_rows(run):
    """The tp ranks of one dp index take the same slice and the same items."""
    for res in run["ranks"]:
        d = res["dp_rank"]
        assert res["slices"] == ((4 * d, 4 * d + 4), list(range(d, 10 - (10 % 2), 2)))


def test_dp_collectives(run):
    """all_gather over dp concatenates the ranks' blocks in dp order; the
    reduce-scatter gives each rank its block of the sum."""
    dp, tp = run["dp"], run["tp"]
    for res in run["ranks"]:
        c, d = res["collectives"], res["dp_rank"]
        peers = [d2 * tp + res["tp_rank"] for d2 in range(dp)]
        want = np.concatenate([np.arange(4.0).reshape(2, 2) + 10 * p for p in peers], axis=1)
        np.testing.assert_array_equal(c["dp_gather"], want)
        total = sum(np.arange(4.0).reshape(2, 2) + 10 * p for p in peers)
        np.testing.assert_array_equal(c["dp_scatter"], total)
