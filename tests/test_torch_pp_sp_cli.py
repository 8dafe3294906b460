"""The port's training CLI with `--pp` and `--sp` on the CPU, on tiny random
VoMix files (two steps, an eval and a save at step 2), in
tests/test_torch_tp_cli.py's manner:

  * `--dp 1`, the reference; `--pp 2 --pp_microbatches 2` (two stages over
    gloo; with `--tp 2 --fsdp`, which JAX ignores under pp, and the notes
    saying so), `--sp 2` (two sequence shards) and `--dp 2 --sp 2 --fsdp`
    (four ranks, the parameters split over dp): the losses, grad norms and
    the eval of `--dp 1` to 1e-5 relative;
  * under `--pp` the checkpoint holds JAX's {'stacked', 'rest'} layout
    (each stacked leaf [depth, ...]) and `ema_canonical.npz` beside it, the
    EMA in the canonical layout, bit-equal to the unstacked state's and
    read by `pipeline.load_checkpoint` into a sampling model; under `--sp`
    the plain layout; both within 6 lr of the one-process state;
  * `--pp 2 --resume` continues from its stacked checkpoint: the next
    step's loss that of the one-process run resumed from its own (1e-4
    relative: the states differ at rounding level);
  * JAX's exits for `--pp` / `--sp` with `--text2semantic`."""

import os
import shutil

import numpy as np
import pytest
import torch

from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.pipeline import load_checkpoint
from covomix_tpu_torch.train import cli

from test_torch_dp_cli import CLUSTER_VARS, _argv, _metrics, _steps, _write_items
from test_torch_tp_cli import RESUME_RTOL, STATE_ATOL, _run_all, _state

LOSS_RTOL = 1e-5
PP_FLAGS = ["--pp", "2", "--pp_microbatches", "2"]
RUNS = {"pp2": [*PP_FLAGS, "--tp", "2", "--fsdp"], "sp2": ["--sp", "2"], "dp2_sp2_fsdp": ["--dp", "2", "--sp", "2",
                                                                                          "--fsdp"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_sp_cli")
    data, logs = root / "data", root / "logs"
    _write_items(data)
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS and not k.startswith("SLURM_")}
    env["OMP_NUM_THREADS"] = "1"
    two = ["--max_steps", "2"]
    out = _run_all({"plain": _argv(data, logs, "plain", "--dp", "1", *two),
                    "pp2": _argv(data, logs, "pp2", *RUNS["pp2"], *two),
                    "sp2": _argv(data, logs, "sp2", *RUNS["sp2"], *two)}, env)
    for src, dst in (("plain", "plain_resume"), ("pp2", "pp2_resume")):
        shutil.copytree(logs / src, logs / dst)
    out.update(_run_all({"dp2_sp2_fsdp": _argv(data, logs, "dp2_sp2_fsdp", *RUNS["dp2_sp2_fsdp"], *two),
                         "plain_resume": _argv(data, logs, "plain_resume", "--dp", "1", "--resume"),
                         "pp2_resume": _argv(data, logs, "pp2_resume", *PP_FLAGS, "--resume")}, env))
    return {"logs": logs, "out": out}


@pytest.mark.parametrize("run", list(RUNS))
def test_pp_sp_runs_give_the_losses_of_one_process(runs, run):
    plain, got = _steps(runs["out"]["plain"]), _steps(runs["out"][run])
    assert [r["step"] for r in got] == [r["step"] for r in plain] == [1, 2]
    for a, b in zip(plain, got):
        np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=LOSS_RTOL)
    ev = [[r["eval_l2"] for r in _metrics(runs["logs"], name) if "eval_l2" in r] for name in ("plain", run)]
    assert len(ev[1]) == 1
    np.testing.assert_allclose(ev[1], ev[0], rtol=LOSS_RTOL)
    assert runs["out"][run].count("eval:") == 1 and runs["out"][run].count("done: 2 steps") == 1


def test_tp_and_fsdp_are_noted_under_pp(runs):
    out = runs["out"]["pp2"]
    assert "note: --tp 2 has no effect under --pp / --sp" in out
    assert "note: --fsdp has no effect under --pp" in out


def test_pp_checkpoint_is_stacked_with_a_canonical_sidecar(runs):
    """The stacked state at step 2; the sidecar bit-equal to its EMA
    unstacked, near the one-process EMA, and a sampling model."""
    ckpt = runs["logs"] / "pp2" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["ema_canonical.npz", "ema_canonical.npz.json", "step_00000002", "topk.json"]
    state, plain = _state(runs["logs"], "pp2", 2), _state(runs["logs"], "plain", 2)
    assert state["params/stacked/qkv/w"].shape == (2, 32, 96) and "params/rest/to_embed/w" in state
    assert state["params/stacked/skip/w"].shape == (2, 64, 32) and not state["params/stacked/skip/w"][0].any()
    params, cfg = load_checkpoint(str(ckpt / "ema_canonical.npz"), PA.AcousticConfig)
    assert (cfg.dim, cfg.depth, cfg.mode) == (32, 2, "two_one")
    stacked = {k[len("ema_params/stacked/"):]: v for k, v in state.items() if k.startswith("ema_params/stacked/")}
    for i, layer in enumerate(params["layers"]):
        for name, leaf in (("qkv/w", layer["qkv"]["w"]), ("ff2/b", layer["ff2"]["b"])):
            np.testing.assert_array_equal(leaf, stacked[name][i])
        assert ("skip" in layer) == (i >= 1)
    np.testing.assert_array_equal(params["to_embed"]["w"], state["ema_params/rest/to_embed/w"])
    np.testing.assert_allclose(params["layers"][1]["skip"]["w"], plain["ema_params/layers/1/skip/w"], rtol=0,
                               atol=STATE_ATOL)
    rs = np.random.RandomState(3)
    y = PA.sample(params_from_numpy(params, "cpu"), cfg, torch.Generator().manual_seed(0),
                  torch.from_numpy(rs.randint(0, 500, (1, 24, 2))),
                  torch.from_numpy(rs.randn(1, 24, 160).astype(np.float32)), step_size=0.25)
    assert y.shape == (1, 24, 80) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("run", ["sp2", "dp2_sp2_fsdp"])
def test_sp_checkpoints_hold_the_plain_layout(runs, run):
    want, got = _state(runs["logs"], "plain", 2), _state(runs["logs"], run, 2)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=0, atol=STATE_ATOL if v.dtype.kind == "f" else 0, err_msg=k)
    assert not os.path.exists(runs["logs"] / run / "checkpoints" / "ema_canonical.npz")


def test_resume_under_pp(runs):
    got, want = _steps(runs["out"]["pp2_resume"]), _steps(runs["out"]["plain_resume"])
    assert "resumed from step 2" in runs["out"]["pp2_resume"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3]
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"], rtol=RESUME_RTOL)
    state = _state(runs["logs"], "pp2_resume", 3)
    assert int(state["step"]) == 3 and state["params/stacked/qkv/w"].shape == (2, 32, 96)


@pytest.mark.parametrize("flag", ["--pp", "--sp"])
def test_pp_sp_refuse_text2semantic(tmp_path, flag):
    with pytest.raises(SystemExit, match="apply to the acoustic model only"):
        cli.main(["--base_dir", str(tmp_path), "--device", "cpu", "--text2semantic", flag, "2"])
