"""The port's training data pipeline and CLI.

The dataset and loader against covomix_tpu.data.datasets on the same files
and seed (same batches, bit for bit); `python -m covomix_tpu_torch.train
--device cpu` for two steps on tiny random VoMix files, then `--resume` for a
third; and the flag combinations that JAX's train.py refuses."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from covomix_tpu.data import datasets as JD
import torch

from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.data import datasets as PD
from covomix_tpu_torch.train import cli, loop
from covomix_tpu_torch.util.misc import named_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--CoVoMix_dim_transformer", "32", "--CoVoMix_depth", "2", "--CoVoMix_heads", "2",
        "--CoVoMix_dim_head", "16"]


def _write_items(root, fmt, n, seed=0):
    """n random items of `fmt` with lengths around the 800-frame crop; codes
    saved as string arrays, as the corpora store them."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = 700 + 37 * i
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", rs.randn(80, t).astype(np.float32))
        if fmt == "hubert_fisher":
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, t).astype(str))
            continue
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", rs.randn(80, t).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t + 3).astype(str))


@pytest.mark.parametrize("fmt", ["hubert_fisher", "hubert_overlap_two_input_one_output"])
def test_dataset_gives_the_jax_packages_batches(tmp_path, fmt):
    _write_items(str(tmp_path), fmt, 7)
    for workers in (0, 1):   # 1: the prefetch thread keeps the order
        jds = JD.CoVoMixDataset(str(tmp_path), format=fmt, random_mask=True, seed=3)
        pds = PD.CoVoMixDataset(str(tmp_path), format=fmt, random_mask=True, seed=3)
        assert pds.files == jds.files and len(pds) == 7
        jl = JD.data_loader(jds, 3, JD.collate_acoustic, seed=3)
        pl = PD.data_loader(pds, 3, PD.collate_acoustic, seed=3, num_workers=workers)
        for _ in range(5):     # past the end of the first epoch (drop_last)
            jb, pb = next(jl), next(pl)
            assert jb.keys() == pb.keys()
            for key in jb:
                assert jb[key].dtype == pb[key].dtype and np.array_equal(jb[key], pb[key]), key
        assert pb["x"].shape[1] == 832 and pb["x"].shape[2] == (80 if fmt == "hubert_fisher" else 240)
        if workers:
            pl.close()
    # fresh datasets: the prefetch thread above drew items ahead from pds's rng
    jds = JD.CoVoMixDataset(str(tmp_path), format=fmt, random_mask=True, seed=3)
    pds = PD.CoVoMixDataset(str(tmp_path), format=fmt, random_mask=True, seed=3)
    stacked = PD.stack_microbatches([PD.collate_acoustic([pds[0]]), PD.collate_acoustic([pds[1], pds[2]])])
    ref = JD.stack_microbatches([JD.collate_acoustic([jds[0]]), JD.collate_acoustic([jds[1], jds[2]])])
    assert all(np.array_equal(stacked[k], ref[k]) for k in ref)


def _train(data, logs, *extra):
    return subprocess.run(
        [sys.executable, "-m", "covomix_tpu_torch.train", "--device", "cpu", "--base_dir", str(data),
         "--format", "hubert_overlap_two_input_one_output", "--twocondition_oneoutput", "--CoVoMix_dim", "160",
         *TINY, "--cond_drop_prob", "0.3", "--random_mask", "--batch_size", "2", "--lr_scheduler",
         "--log_dir", str(logs), "--run_name", "smoke", "--log_every", "1", "--eval_every", "2",
         "--num_eval_files", "2", "--ckpt_every", "1000", "--no_wandb", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_train_cli_two_steps_then_resume(tmp_path):
    """Two steps with an eval and a top-k save at step 2, then --resume for
    a third step from step 2's state."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    rs = np.random.RandomState(2)
    data.mkdir()
    for i in range(5):
        t = 40 + 8 * i
        base = data / f"u{i}"
        np.save(f"{base}.mel.npy", rs.randn(80, t).astype(np.float32))
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", rs.randn(80, t).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))
    r = _train(data, logs, "--max_steps", "2")
    assert r.returncode == 0, r.stderr[-2500:]
    run = logs / "smoke"
    lines = [json.loads(line) for line in open(run / "metrics.jsonl") if line.strip()]
    steps = [rec for rec in lines if "train_loss" in rec]
    assert [rec["step"] for rec in steps] == [1, 2]
    assert all(np.isfinite(rec["train_loss"]) and np.isfinite(rec["grad_norm"]) for rec in steps)
    assert any("eval_l2" in rec for rec in lines)
    ckpt = run / "checkpoints"
    topk = json.load(open(ckpt / "topk.json"))
    assert topk["best_step"] == 2 and (ckpt / "step_00000002" / "state.npz").is_file()

    r = _train(data, logs, "--max_steps", "3", "--resume")
    assert r.returncode == 0, r.stderr[-2500:]
    assert "resumed from step 2" in r.stdout
    steps = [json.loads(line) for line in open(run / "metrics.jsonl") if "train_loss" in line]
    assert [rec["step"] for rec in steps] == [1, 2, 3]
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003", "topk.json"]
    with np.load(ckpt / "step_00000003" / "state.npz") as z:
        assert int(z["step"]) == 3 and int(z["adam_step"]) == 3 and int(z["ema_num_updates"]) == 3


def test_train_state_round_trip_continues_identically(tmp_path):
    """save_train_state / load_train_state carry parameters, Adam moments,
    EMA and counters: a state loaded into a fresh model takes the very same
    next step as the one that was saved."""
    def fresh():
        g = torch.Generator().manual_seed(0)
        return loop.init_train_state({"w": torch.randn(4, 3, generator=g), "b": [torch.randn(3, generator=g)]},
                                     loop.TrainConfig(lr=1e-2, use_lr_schedule=True, steps_per_epoch=1))

    def loss_fn(params, batch, generator):
        return torch.sum((batch["x"] @ params["w"] + params["b"][0]) ** 2)

    cfg = loop.TrainConfig(lr=1e-2, use_lr_schedule=True, steps_per_epoch=1)
    step = loop.make_train_step(loss_fn, cfg)
    batch = {"x": np.random.RandomState(0).randn(5, 4).astype(np.float32)}
    a = fresh()
    for _ in range(2):
        step(a, batch, None)
    cio.save_train_state(str(tmp_path), a, 2)
    b = cio.load_train_state(str(tmp_path), 2, fresh())
    assert (b.step, b.ema_num_updates) == (2, 2) and cio.latest_step(str(tmp_path)) == 2
    step(a, batch, None)
    step(b, batch, None)
    for (_, x), (_, y) in zip(named_leaves([a.params, a.ema_params]), named_leaves([b.params, b.ema_params])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("flags,exc,item", [
    (["--pp", "2", "--sp", "2"], SystemExit, "choose one of --pp / --sp"),
    (["--pp", "2", "--grad_accum", "2"], SystemExit, "--grad_accum composes with single-host"),
    (["--bmuf_sync", "2", "--grad_accum", "2"], SystemExit, "--grad_accum composes with single-host"),
    (["--sp", "2", "--steps_per_dispatch", "2"], SystemExit, "--steps_per_dispatch composes with single-host"),
    (["--bmuf_sync", "2", "--steps_per_dispatch", "2"], SystemExit, "--steps_per_dispatch composes with single-host"),
])
def test_unported_flags_raise(tmp_path, flags, exc, item):
    """What the CLI refuses: JAX's exits for the --pp / --sp / --bmuf_sync
    combinations it refuses."""
    with pytest.raises(exc, match=item):
        cli.main(["--base_dir", str(tmp_path), "--device", "cpu", *flags])


LOGGER_CHILD = """
import sys
from covomix_tpu_torch.util.logging_utils import MetricsLogger
log = MetricsLogger(sys.argv[1], tensorboard=True)
log.log(1, {"loss": 2.5})
log.log(2, {"loss": 1.5, "l2": 0.25}, prefix="eval_")
log.close()
assert log._tb is None
assert "tensorflow" not in sys.modules, "TensorFlow was imported for the event files"
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
acc = EventAccumulator(sys.argv[1] + "/tb")
acc.Reload()
print({tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]})
"""


def test_metrics_logger_writes_events_without_tensorflow(tmp_path):
    """The metrics logger's JSONL lines and TensorBoard scalars (read back
    with TensorBoard's own reader), written without importing TensorFlow
    (a fresh process: this one may hold it already)."""
    r = subprocess.run([sys.executable, "-c", LOGGER_CHILD, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2500:]
    assert r.stdout.strip().splitlines()[-1] == str({"loss": [(1, 2.5)], "eval_loss": [(2, 1.5)],
                                                     "eval_l2": [(2, 0.25)]})
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [(rec["step"], {k: v for k, v in rec.items() if k not in ("step", "time")}) for rec in lines] == [
        (1, {"loss": 2.5}), (2, {"eval_loss": 1.5, "eval_l2": 0.25})]
