"""The port's training CLI with `--tp` and `--fsdp` on the CPU, on tiny
random VoMix files (three steps, an eval at step 2), in
tests/test_torch_dp_cli.py's manner:

  * `--dp 1`, the reference; `--tp 2` (two ranks over gloo splitting the
    weights) and `--dp 2 --fsdp` (two ranks splitting every parameter, its
    Adam moments and EMA): the losses, grad norms and the eval of `--dp 1`
    to 1e-5 relative, rank 0 alone writing, the checkpoints in the full
    layout (every array of the one-process run's, of its shape, within 6 lr
    of it after three steps at lr 1e-4);
  * a one-process run resumes from the `--tp 2` and the `--fsdp`
    checkpoints, and a `--tp 2` run from the one-process checkpoint: each
    next step's loss that of the one-process run resumed from its own
    checkpoint (1e-4 relative: the states differ at rounding level);
  * JAX's refusals stand: `--bmuf_sync` with `--tp`, and `--fsdp` in a
    multi-process group (`--multihost` in a group of two)."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from covomix_tpu_torch.parallel import multihost as MH
from covomix_tpu_torch.train import cli

import _torch_tp_child
from test_torch_dp_cli import CLUSTER_VARS, REPO, _argv, _metrics, _steps, _write_items

LOSS_RTOL = 1e-5
RESUME_RTOL = 1e-4
STATE_ATOL = 6e-4        # 3 Adam steps at lr <= 1e-4, each moving an element by at most ~1.0055 lr, twice


def _run_all(cmds, env):
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
    return {k: v[0] for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_cli")
    data, logs = root / "data", root / "logs"
    _write_items(data)
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS and not k.startswith("SLURM_")}
    env["OMP_NUM_THREADS"] = "1"
    out = _run_all({"plain": _argv(data, logs, "plain", "--dp", "1"),
                    "tp2": _argv(data, logs, "tp2", "--dp", "1", "--tp", "2"),
                    "fsdp": _argv(data, logs, "fsdp", "--dp", "2", "--fsdp")}, env)
    resumes = {"from_plain": ("plain", ["--dp", "1"]), "from_tp2": ("tp2", ["--dp", "1"]),
               "from_fsdp": ("fsdp", ["--dp", "1"]), "tp2_from_plain": ("plain", ["--dp", "1", "--tp", "2"])}
    for name, (src, _) in resumes.items():
        shutil.copytree(logs / src, logs / name)
    out.update(_run_all({name: _argv(data, logs, name, *flags, "--max_steps", "4", "--resume")
                         for name, (_, flags) in resumes.items()}, env))
    return {"logs": logs, "out": out}


def _state(logs, run, step):
    with np.load(logs / run / "checkpoints" / f"step_{step:08d}" / "state.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("run", ["tp2", "fsdp"])
def test_sharded_runs_give_the_losses_of_one_process(runs, run):
    plain, got = _steps(runs["out"]["plain"]), _steps(runs["out"][run])
    assert [r["step"] for r in got] == [r["step"] for r in plain] == [1, 2, 3]
    for a, b in zip(plain, got):
        np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=LOSS_RTOL)
    ev = [[r["eval_l2"] for r in _metrics(runs["logs"], name) if "eval_l2" in r] for name in ("plain", run)]
    assert len(ev[1]) == 1
    np.testing.assert_allclose(ev[1], ev[0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", ["tp2", "fsdp"])
def test_rank0_writes_full_layout_checkpoints(runs, run):
    """The save at the eval and the final save, each once, holding every
    array of the one-process run's checkpoint at its shape and close to it."""
    stdout = runs["out"][run]
    assert stdout.count("eval:") == 1 and stdout.count("done: 3 steps") == 1
    assert sorted(os.listdir(runs["logs"] / run / "checkpoints")) == ["step_00000002", "step_00000003", "topk.json"]
    for step in (2, 3):
        want, got = _state(runs["logs"], "plain", step), _state(runs["logs"], run, step)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=STATE_ATOL if got[k].dtype.kind == "f" else 0,
                                       err_msg=k)
        assert (int(got["step"]), int(got["adam_step"]), int(got["ema_num_updates"])) == (step,) * 3


@pytest.mark.parametrize("name,ref", [("from_tp2", "from_plain"), ("from_fsdp", "from_plain"),
                                      ("tp2_from_plain", "from_plain")])
def test_resume_across_layouts(runs, name, ref):
    got, want = _steps(runs["out"][name]), _steps(runs["out"][ref])
    assert "resumed from step 3" in runs["out"][name]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [4]
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"], rtol=RESUME_RTOL)
    assert int(_state(runs["logs"], name, 4)["step"]) == 4


def test_bmuf_with_tp_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="composes with none of --tp/--pp/--sp/--fsdp/--multihost"):
        cli.main(["--base_dir", str(tmp_path), "--device", "cpu", "--bmuf_sync", "2", "--tp", "2"])


def test_fsdp_in_a_multi_process_group_is_refused(tmp_path):
    """JAX refuses --fsdp with more than one process (train.py:233-236)."""
    argv = ["--base_dir", str(tmp_path), "--device", "cpu", "--multihost", "--fsdp", "--log_dir", str(tmp_path)]
    MH.spawn(_torch_tp_child.cli_rank, 2, argv, device="cpu")
    for r in range(2):
        msg = (tmp_path / f"exit{r}.txt").read_text()
        assert "--fsdp with --multihost" in msg, msg
