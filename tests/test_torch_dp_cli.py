"""The port's training CLI with data parallelism on the CPU, four runs at
once on tiny random VoMix files (three steps, an eval at step 2):

  * `--dp 1`, the reference;
  * `--dp 2`: two ranks over gloo from the one command, each running the
    global loader and keeping its rows, with the draws of the global batch:
    the losses of `--dp 1` to 1e-5 relative (the ranks sum their halves in
    another order), rank 0 alone printing, logging and saving;
  * `--multihost` with no cluster in the environment: JAX's note, then the
    plain run, its losses bit for bit;
  * `--coordinator_address` with `--num_processes 2`: two processes, each on
    its rank-strided files, rank 0 alone writing;
  * `--steps_per_dispatch 2` at `--dp 1` and at `--dp 2` (the sharded
    multi-step): two dispatches (the third step overshoots to 4), the
    losses of the two to 1e-5 relative."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from covomix_tpu_torch.parallel.multihost import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _write_items(data):
    rs = np.random.RandomState(2)
    data.mkdir()
    for i in range(5):
        t = 40 + 8 * i
        base = data / f"u{i}"
        np.save(f"{base}.mel.npy", rs.randn(80, t).astype(np.float32))
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", rs.randn(80, t).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))


def _argv(data, logs, run, *extra):
    return [sys.executable, "-m", "covomix_tpu_torch.train", "--device", "cpu", "--base_dir", str(data),
            "--format", "hubert_overlap_two_input_one_output", "--twocondition_oneoutput", "--CoVoMix_dim", "160",
            "--CoVoMix_dim_transformer", "32", "--CoVoMix_depth", "2", "--CoVoMix_heads", "2",
            "--CoVoMix_dim_head", "16", "--cond_drop_prob", "0.3", "--random_mask", "--batch_size", "2",
            "--lr_scheduler", "--log_dir", str(logs), "--run_name", run, "--log_every", "1", "--eval_every", "2",
            "--num_eval_files", "2", "--ckpt_every", "1000", "--no_wandb", "--max_steps", "3", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    data, logs = root / "data", root / "logs"
    _write_items(data)
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS and not k.startswith("SLURM_")}
    env["OMP_NUM_THREADS"] = "1"
    coord = f"127.0.0.1:{free_port()}"
    cmds = {"plain": _argv(data, logs, "plain", "--dp", "1"), "dp2": _argv(data, logs, "dp2", "--dp", "2"),
            "multihost": _argv(data, logs, "multihost", "--multihost"),
            "k2_dp1": _argv(data, logs, "k2_dp1", "--dp", "1", "--steps_per_dispatch", "2"),
            "k2_dp2": _argv(data, logs, "k2_dp2", "--dp", "2", "--steps_per_dispatch", "2"),
            **{f"coord{i}": _argv(data, logs, "coord", "--coordinator_address", coord, "--num_processes", "2",
                                  "--process_id", str(i)) for i in range(2)}}
    procs = {k: subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    try:
        out = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}: rc {p.returncode}\n{out[k][1][-2500:]}"
    return {"logs": logs, "out": {k: v[0] for k, v in out.items()}}


def _steps(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith('{"step"')]


def _metrics(logs, run):
    with open(logs / run / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_dp2_gives_the_losses_of_dp1(runs):
    plain, dp2 = _steps(runs["out"]["plain"]), _steps(runs["out"]["dp2"])
    assert [r["step"] for r in plain] == [r["step"] for r in dp2] == [1, 2, 3]
    for a, b in zip(plain, dp2):
        np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", ["dp2", "coord"])
def test_rank0_alone_writes(runs, run):
    """One line per step on stdout and in metrics.jsonl, one eval, the top-k
    save at the eval and the final save, each once."""
    stdout = runs["out"]["coord0" if run == "coord" else run]
    assert [r["step"] for r in _steps(stdout)] == [1, 2, 3]
    assert stdout.count("eval:") == 1 and stdout.count("done: 3 steps") == 1
    lines = _metrics(runs["logs"], run)
    assert [r["step"] for r in lines if "train_loss" in r] == [1, 2, 3]
    assert len([r for r in lines if "eval_l2" in r]) == 1
    assert all(np.isfinite(r["train_loss"]) for r in lines if "train_loss" in r)
    ckpt = runs["logs"] / run / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003", "topk.json"]
    if run == "coord":
        assert not _steps(runs["out"]["coord1"]) and "done:" not in runs["out"]["coord1"]


def test_multihost_without_cluster_is_the_plain_run(runs):
    assert "no cluster detected" in runs["out"]["multihost"]
    assert _steps(runs["out"]["multihost"])[-1]["step"] == 3
    for a, b in zip(_steps(runs["out"]["plain"]), _steps(runs["out"]["multihost"])):
        assert (a["train_loss"], a["grad_norm"]) == (b["train_loss"], b["grad_norm"])


def test_dp2_steps_per_dispatch_gives_the_losses_of_dp1(runs):
    """The sharded multi-step at dp=2 against the multi-step at dp=1: the
    dispatches' last steps logged (2 and 4, past --max_steps 3), their
    losses and grad norms to 1e-5 relative; the evals where a multiple of 2
    falls inside a dispatch."""
    one, two = _steps(runs["out"]["k2_dp1"]), _steps(runs["out"]["k2_dp2"])
    assert [r["step"] for r in one] == [r["step"] for r in two] == [2, 4]
    for a, b in zip(one, two):
        np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=LOSS_RTOL)
    assert runs["out"]["k2_dp2"].count("eval:") == 2 and "done: 4 steps" in runs["out"]["k2_dp2"]
