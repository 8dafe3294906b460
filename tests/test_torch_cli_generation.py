"""The port's generation CLIs end to end on the CPU (`--device cpu`): tiny
random checkpoints written by the JAX package's `save_params`, prompts and
scripts in the JAX CLIs' file conventions, one wav per script plus
config.txt. The in-process runs cap the T2S decode at MAX_LEN steps: random
weights rarely sample EOS, and the CLIs' default of 2048 steps would make
each run a long eager loop on the CPU."""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from covomix_tpu.audio import save_wav
from covomix_tpu.checkpoint import io as jio
from covomix_tpu.models import acoustic as JA, text2semantic as JT, vocoder as JV
from covomix_tpu_torch.audio.wav import load_wav
from covomix_tpu_torch import dialogue_generation, monologue_generation
from covomix_tpu_torch import pipeline as P

import _torch_ckpt as CK
from _torch_port import J_AC_CKPT, J_T2S_CKPT   # importing it sets one torch thread beside the XLA client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 64      # 30 prompt frames + 64 fit one 128-frame bucket


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    key = jax.random.PRNGKey(0)
    t2s_cfg = JT.T2SConfig(num_text_tokens=512, num_semantic_tokens=502, dim=32, source_depth=1, target_depth=1,
                           heads=2, dim_head=16, two_output=True, target_dim=32)
    mix_cfg = JA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                                num_phoneme_tokens=502, mode="two_one")
    single_cfg = JA.AcousticConfig(dim_in=80, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                                   num_phoneme_tokens=502, mode="single")
    voc_cfg = JV.VocoderConfig(upsample_initial_channel=32)
    for i, (name, init, cfg) in enumerate((("t2s", JT.init, t2s_cfg), ("acoustic", JA.init, mix_cfg),
                                           ("acoustic_single", JA.init, single_cfg),
                                           ("vocoder", JV.init_generator, voc_cfg))):
        jio.save_params(str(root / f"{name}.npz"), jax.jit(init, static_argnums=1)(jax.random.fold_in(key, i), cfg),
                        meta={"config": cfg.__dict__})
    (root / "texts").mkdir()
    (root / "prompts").mkdir()
    (root / "texts" / "utt1.txt").write_text("hello world [spkchange] this is a test")
    rng = np.random.RandomState(0)
    for stem in ("utt1", "utt1_1", "utt1_2"):
        np.save(str(root / "prompts" / f"{stem}.hubert_code.npy"), rng.randint(0, 500, size=30).astype(str))
        save_wav(str(root / "prompts" / f"{stem}.wav"), rng.randn(30 * 160).astype(np.float32) * 0.05, 8000)
    return root


@pytest.fixture(autouse=True)
def short_decode(monkeypatch):
    monkeypatch.setattr(monologue_generation, "load_synthesizer",
                        functools.partial(P.load_synthesizer, t2s_max_length=MAX_LEN))


def _args(assets, out, acoustic="acoustic.npz", extra=()):
    return ["--t2s_ckpt", str(assets / "t2s.npz"), "--acous_ckpt", str(assets / acoustic),
            "--hifigan_ckpt", str(assets / "vocoder.npz"), "--text_dir", str(assets / "texts"),
            "--prompt_dir", str(assets / "prompts"), "--saved_dir", str(out), "--allow_fallback_vocab",
            "--device", "cpu", *extra]


def _check_output(out, assets):
    wav, sr = load_wav(str(out / "utt1.wav"))
    assert sr == 8000 and len(wav) > 0 and len(wav) % 160 == 0 and np.isfinite(wav).all()
    cfg = (out / "config.txt").read_text()
    assert str(assets / "vocoder.npz") in cfg and str(assets / "t2s.npz") in cfg


@pytest.mark.parametrize("mode", ["covosingle", "covomix"])
def test_monologue_cli(assets, mode, tmp_path, capsys):
    acoustic = "acoustic_single.npz" if mode == "covosingle" else "acoustic.npz"
    monologue_generation.main(_args(assets, tmp_path, acoustic, ["--mode", mode]))
    _check_output(tmp_path, assets)
    assert "RTF" in capsys.readouterr().out


@pytest.mark.parametrize("fuse_tail", [False, True], ids=["exact", "fuse_tail"])
def test_dialogue_cli_covomix(assets, fuse_tail, tmp_path):
    dialogue_generation.main(_args(assets, tmp_path, extra=["--mode", "covomix"] + (["--fuse_tail"] if fuse_tail else [])))
    _check_output(tmp_path, assets)


def test_dialogue_cli_as_module(assets, tmp_path):
    """The dialogue CLI run as `__main__` from the repo root in a fresh
    process, as `python -m covomix_tpu_torch.dialogue_generation` runs it
    (runpy, with the decode capped as in the in-process tests)."""
    launcher = ("import functools, runpy, sys\n"
                "from covomix_tpu_torch import monologue_generation as M, pipeline as P\n"
                f"M.load_synthesizer = functools.partial(P.load_synthesizer, t2s_max_length={MAX_LEN})\n"
                "sys.argv[0] = 'dialogue_generation'\n"
                "runpy.run_module('covomix_tpu_torch.dialogue_generation', run_name='__main__', alter_sys=True)\n")
    res = subprocess.run([sys.executable, "-c", launcher, *_args(assets, tmp_path, extra=["--f32"])],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RTF" in res.stdout and "float32" in res.stdout
    _check_output(tmp_path, assets)


def test_torch_checkpoint_and_speculative_refused(assets, tmp_path):
    """The released PyTorch formats are read directly: the dialogue CLI run
    from Lightning `.ckpt` files (T2S and acoustic, EMA weights) and a
    HiFi-GAN `g_<step>` gives the wav of the run from the `.npz` files they
    were made from, within one int16 step (the T2S and acoustic trees come
    back bit for bit, the folded vocoder to f32 rounding). --speculative on
    a T2S checkpoint without the early-exit draft head is refused with the
    JAX Synthesizer's ValueError, from the `.npz` and from the `.ckpt`."""
    key = jax.random.PRNGKey(7)
    for name, init, cfg, kind in (("t2s", JT.init, J_T2S_CKPT, "t2s"), ("acoustic", JA.init, J_AC_CKPT, "acoustic")):
        tree = jax.tree_util.tree_map(np.asarray, jax.jit(init, static_argnums=1)(jax.random.fold_in(key, len(name)),
                                                                                    cfg))
        jio.save_params(str(tmp_path / f"{name}.npz"), tree, meta={"config": cfg.__dict__})
        CK.write_lightning_ckpt(str(tmp_path / f"{name}.ckpt"), tree, cfg, kind)
    (tmp_path / "voc").mkdir()
    CK.write_hifigan_ckpt(str(tmp_path / "voc" / "g_00400000"), jio.load_params(str(assets / "vocoder.npz")),
                          JV.VocoderConfig(upsample_initial_channel=32))
    wavs = []
    for ckpts in ((tmp_path / "t2s.npz", tmp_path / "acoustic.npz", assets / "vocoder.npz"),
                  (tmp_path / "t2s.ckpt", tmp_path / "acoustic.ckpt", tmp_path / "voc" / "g_00400000")):
        argv = _args(assets, tmp_path / f"out{len(wavs)}", extra=["--mode", "covomix"])
        for flag, path in zip(("--t2s_ckpt", "--acous_ckpt", "--hifigan_ckpt"), ckpts):
            argv[argv.index(flag) + 1] = str(path)
        dialogue_generation.main(argv)
        wavs.append(wavfile.read(str(tmp_path / f"out{len(wavs)}" / "utt1.wav"))[1].astype(np.int32))
    assert len(wavs[0]) > 0 and wavs[0].shape == wavs[1].shape
    assert np.abs(wavs[0] - wavs[1]).max() <= 1
    for t2s in ("t2s.npz", "t2s.ckpt"):
        argv = _args(assets, tmp_path / "spec", extra=["--speculative"])
        argv[argv.index("--t2s_ckpt") + 1] = str(tmp_path / t2s)
        with pytest.raises(ValueError, match="early-exit head"):
            dialogue_generation.main(argv)


def test_cuda_is_the_default_device(assets, tmp_path):
    """Without --device the CLIs ask for cuda, and raise where there is none."""
    import torch

    if torch.cuda.is_available():
        return
    args = [a for a in _args(assets, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        dialogue_generation.main(args)
