"""`python -m covomix_tpu_torch.hifigan_train --dp 2 --device cpu`: two
ranks over gloo from the one command (a tiny generator, initial channel 16,
segment 1600, the config's batch of 2 split one row a rank), one step with
a validation and a checkpoint; rank 0 alone prints, validates and writes
the `g_` generator and the train state, which a one-device run resumes."""

import json
import os

import numpy as np
import torch

from covomix_tpu_torch import hifigan_train as HT
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.models import vocoder as PV
from covomix_tpu_torch.train import gan as PG

from test_torch_hifigan_train import LOSSES, json_lines, write_assets


def test_dp2_runs_and_rank0_alone_writes(tmp_path, capfd, monkeypatch):
    root = str(tmp_path)
    write_assets(root)
    ckpt = os.path.join(root, "cp")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")      # read by the ranks' fresh interpreters
    state = HT.main(["--input_wavs_dir", os.path.join(root, "wavs"), "--config", os.path.join(root, "config.json"),
                     "--checkpoint_path", ckpt, "--device", "cpu", "--num_workers", "1", "--stdout_interval", "1",
                     "--training_steps", "1", "--checkpoint_interval", "1", "--dp", "2",
                     "--input_validation_dir", os.path.join(root, "val"), "--validation_interval", "1"])
    out = capfd.readouterr().out
    assert state is None and "dp mesh over 2 devices" in out
    lines = json_lines(out)
    steps = [r for r in lines if "loss_gen" in r]
    assert [r["step"] for r in steps] == [1] and all(np.isfinite(steps[0][k]) for k in LOSSES)
    assert [r["step"] for r in lines if "validation_mel_l1" in r] == [1]
    assert out.count("training wavs") == 1
    assert sorted(os.listdir(ckpt)) == ["g_00000001.npz", "g_00000001.npz.json", "metrics.jsonl", "step_00000001",
                                        "tb"]
    fresh = PG.init_gan_state(torch.Generator().manual_seed(9), PV.VocoderConfig(upsample_initial_channel=16),
                              PG.GanConfig(segment_size=1600))
    saved = pio.load_train_state(ckpt, 1, fresh)
    assert saved.step == 1 and PG.opt_count(saved.opt_g) == PG.opt_count(saved.opt_d) == 1
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f if "validation_mel_l1" in line] == [1]
