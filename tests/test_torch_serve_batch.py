"""The port's serving CLI (`python -m covomix_tpu_torch.serve_batch`) takes the
JAX CLI's flags: `--staged` runs (the eager port runs the stages one after
another anyway), and the flags of parts not ported yet, or checkpoints it
cannot read, are refused with a message that names what is missing."""

import dataclasses
import json

import numpy as np
import pytest

from covomix_tpu.checkpoint import io as jio
from covomix_tpu_torch import serve_batch
from covomix_tpu_torch.audio.wav import load_wav

from _torch_port import J_AC, J_T2S, J_VOC, jax_params


def _assets(tmp_path):
    """Tiny `.npz` checkpoints and one script with its two prompts; returns
    the CLI's path arguments."""
    for name, p, cfg in zip(("t2s", "ac", "voc"), jax_params(0), (J_T2S, J_AC, J_VOC)):
        jio.save_params(str(tmp_path / f"{name}.npz"), p,
                        meta={"config": json.loads(json.dumps(dataclasses.asdict(cfg)))})
    (tmp_path / "text").mkdir()
    (tmp_path / "prompt").mkdir()
    (tmp_path / "text" / "a.txt").write_text("hello world [spkchange] good morning")
    rs = np.random.RandomState(1)
    for spk in (1, 2):
        base = tmp_path / "prompt" / f"a_{spk}"
        np.save(f"{base}.hubert_code.npy", rs.randint(0, 500, 12))
        np.save(f"{base}.mel.npy", rs.randn(80, 10 + spk).astype(np.float32))
    return ["--t2s_ckpt", str(tmp_path / "t2s.npz"), "--acous_ckpt", str(tmp_path / "ac.npz"),
            "--hifigan_ckpt", str(tmp_path / "voc.npz"), "--text_dir", str(tmp_path / "text"),
            "--prompt_dir", str(tmp_path / "prompt"), "--saved_dir", str(tmp_path / "out"), "--batch", "2",
            "--decode_len", "16", "--max_text_tokens", "16", "--allow_fallback_vocab", "--device", "cpu"]


def test_staged_is_accepted(tmp_path):
    serve_batch.main(_assets(tmp_path) + ["--staged"])
    wav, sr = load_wav(str(tmp_path / "out" / "a.wav"))
    assert sr == 8000 and 0 < len(wav) <= 16 * 160


@pytest.mark.parametrize("flags", [["--speculative"], ["--spec_gamma", "4"]])
def test_speculative_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="speculative decode"):
        serve_batch.main(_assets(tmp_path) + flags)


def test_multihost_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="Parallelism"):
        serve_batch.main(_assets(tmp_path) + ["--multihost"])


@pytest.mark.parametrize("flag,path", [("--t2s_ckpt", "last.ckpt"), ("--hifigan_ckpt", "g_02500000")])
def test_torch_checkpoints_are_refused(tmp_path, flag, path):
    """The message the generation CLIs give: convert them first."""
    argv = _assets(tmp_path)
    argv[argv.index(flag) + 1] = str(tmp_path / path)
    with pytest.raises(ValueError, match="convert_checkpoint.py"):
        serve_batch.main(argv)
