"""The port's serving CLI (`python -m covomix_tpu_torch.serve_batch`) takes the
JAX CLI's flags: `--staged` runs (the eager port runs the stages one after
another anyway), the flags of parts not ported yet are refused with a
message that names what is missing, and the released PyTorch checkpoint
formats are read as the `.npz` files they convert to."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from covomix_tpu.checkpoint import io as jio
from covomix_tpu.models import text2semantic as JT
from covomix_tpu_torch import serve_batch
from covomix_tpu_torch.audio.wav import load_wav

import _torch_ckpt as CK
from _torch_port import J_AC, J_T2S, J_T2S_CKPT, J_VOC, jax_params


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


@pytest.mark.parametrize("flags", [["--speculative"], ["--speculative", "--spec_gamma", "2"]])
def test_speculative_flags_raise(tmp_path, flags):
    """--speculative on a T2S checkpoint without the early-exit draft head
    raises the JAX BatchedPipeline's AssertionError; nothing falls back to
    sampling."""
    from covomix_tpu.serving import BatchedPipeline as JPipe

    t2s, ac, voc = jax_params(0)
    with pytest.raises(AssertionError, match="early-exit draft head") as jerr:
        JPipe(t2s, J_T2S, ac, J_AC, voc, J_VOC, speculative=True)
    with pytest.raises(AssertionError, match="early-exit draft head") as perr:
        serve_batch.main(_assets(tmp_path) + flags)
    assert str(perr.value) == str(jerr.value)


def test_multihost_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="Parallelism"):
        serve_batch.main(_assets(tmp_path) + ["--multihost"])


@pytest.mark.parametrize("flag,path", [("--t2s_ckpt", "last.ckpt"), ("--hifigan_ckpt", "g_02500000")])
def test_torch_checkpoints_are_refused(tmp_path, flag, path):
    """The released PyTorch formats are read directly: a run from a
    Lightning `.ckpt` (EMA weights) or a HiFi-GAN `g_<step>` (weight norm
    folded) gives the wavs of the run from the `.npz` they were made from:
    the T2S tree comes back bit for bit, so the wavs are equal; the folded
    vocoder to f32 rounding, so the int16 wavs agree within one step."""
    argv = _assets(tmp_path)
    if flag == "--t2s_ckpt":   # a T2S whose hyper_parameters map back to its config
        tree = jax.tree_util.tree_map(np.asarray, jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(5),
                                                                                       J_T2S_CKPT))
        jio.save_params(str(tmp_path / "t2s.npz"), tree,
                        meta={"config": json.loads(json.dumps(dataclasses.asdict(J_T2S_CKPT)))})
        CK.write_lightning_ckpt(str(tmp_path / path), tree, J_T2S_CKPT, "t2s")
    else:
        os.makedirs(tmp_path / "torch")
        CK.write_hifigan_ckpt(str(tmp_path / "torch" / path), jio.load_params(str(tmp_path / "voc.npz")), J_VOC)
        path = os.path.join("torch", path)
    serve_batch.main(argv)
    ref = wavfile.read(str(tmp_path / "out" / "a.wav"))[1]
    argv[argv.index(flag) + 1] = str(tmp_path / path)
    argv[argv.index("--saved_dir") + 1] = str(tmp_path / "out_torch")
    serve_batch.main(argv)
    got = wavfile.read(str(tmp_path / "out_torch" / "a.wav"))[1]
    assert got.shape == ref.shape and len(ref) > 0
    if flag == "--t2s_ckpt":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
