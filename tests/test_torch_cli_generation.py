"""The port's generation CLIs end to end on the CPU (`--device cpu`): tiny
random checkpoints written by the JAX package's `save_params`, prompts and
scripts in the JAX CLIs' file conventions, one wav per script plus
config.txt. The in-process runs cap the T2S decode at MAX_LEN steps: random
weights rarely sample EOS, and the CLIs' default of 2048 steps would make
each run a long eager loop on the CPU.

The per-turn modes (covosingle: CoSingle T2S + VoSingle; covosinx: CoSingle
T2S + VoMix) are also held against the JAX package's CLIs on the same files:
both decode greedily, the port's flow sampler takes the y0 that JAX's draws,
and the prompts carry `.mel.npy` caches so both read the same prompt mel.
f32: the written int16 wavs within WAV_INT16_TOL (the Synthesizer-level
tolerance of tests/test_torch_pipeline.py, 1e-4 of full scale, plus one
step of int16 truncation)."""

import functools
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from covomix_tpu.audio import MelConfig, load_wav as jax_load_wav, mel_spectrogram, save_wav
from covomix_tpu.checkpoint import io as jio
from covomix_tpu.models import acoustic as JA, text2semantic as JT, vocoder as JV
from covomix_tpu_torch.audio.wav import load_wav
from covomix_tpu_torch import dialogue_generation, monologue_generation
from covomix_tpu_torch import pipeline as P
from covomix_tpu_torch.models import text2semantic as PT

import _torch_ckpt as CK
# importing it sets one torch thread beside the XLA client
from _torch_port import GREEDY_THRES, J_AC_CKPT, J_T2S_CKPT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 64      # 30 prompt frames + 64 fit one 128-frame bucket
WAV_INT16_TOL = int(np.ceil(1e-4 * 32767)) + 1
# mode -> (T2S, acoustic) checkpoints the mode pairs, as the JAX package's tests pair them
MODELS = {"covosingle": ("t2s_single.npz", "acoustic_single.npz"), "covosinx": ("t2s_single.npz", "acoustic.npz"),
          "covomix": ("t2s.npz", "acoustic.npz")}


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
    cosingle_cfg = JT.T2SConfig(num_text_tokens=512, num_semantic_tokens=502, dim=32, source_depth=1,
                                target_depth=1, heads=2, dim_head=16, target_dim=32)
    voc_cfg = JV.VocoderConfig(upsample_initial_channel=32)
    for i, (name, init, cfg) in enumerate((("t2s", JT.init, t2s_cfg), ("acoustic", JA.init, mix_cfg),
                                           ("acoustic_single", JA.init, single_cfg),
                                           ("vocoder", JV.init_generator, voc_cfg),
                                           ("t2s_single", JT.init, cosingle_cfg))):
        jio.save_params(str(root / f"{name}.npz"), jax.jit(init, static_argnums=1)(jax.random.fold_in(key, i), cfg),
                        meta={"config": cfg.__dict__})
    (root / "texts").mkdir()
    (root / "prompts").mkdir()
    (root / "texts" / "utt1.txt").write_text("hello world [spkchange] this is a test")
    rng = np.random.RandomState(0)
    for stem in ("utt1", "utt1_1", "utt1_2"):
        np.save(str(root / "prompts" / f"{stem}.hubert_code.npy"), rng.randint(0, 500, size=30).astype(str))
        save_wav(str(root / "prompts" / f"{stem}.wav"), rng.randn(30 * 160).astype(np.float32) * 0.05, 8000)
    # the same prompts with the JAX frontend's mel cached beside each wav
    shutil.copytree(root / "prompts", root / "prompts_mel")
    for stem in ("utt1", "utt1_1", "utt1_2"):
        wav = jax_load_wav(str(root / "prompts" / f"{stem}.wav"), sr=8000)[0]
        with jax.default_matmul_precision("highest"):
            mel = np.asarray(mel_spectrogram(jnp.asarray(wav[None]), MelConfig()))[0]
        np.save(str(root / "prompts_mel" / f"{stem}.mel.npy"), mel)
    return root


@pytest.fixture(autouse=True)
def short_decode(monkeypatch):
    monkeypatch.setattr(monologue_generation, "load_synthesizer",
                        functools.partial(P.load_synthesizer, t2s_max_length=MAX_LEN))


def _args(assets, out, acoustic="acoustic.npz", extra=(), t2s="t2s.npz", prompts="prompts",
          device=("--device", "cpu")):
    return ["--t2s_ckpt", str(assets / t2s), "--acous_ckpt", str(assets / acoustic),
            "--hifigan_ckpt", str(assets / "vocoder.npz"), "--text_dir", str(assets / "texts"),
            "--prompt_dir", str(assets / prompts), "--saved_dir", str(out), "--allow_fallback_vocab",
            *device, *extra]


def _mode_args(assets, out, mode, extra=(), **kw):
    t2s, acoustic = MODELS[mode]
    return _args(assets, out, acoustic, ["--mode", mode, *extra], t2s=t2s, **kw)


def _check_output(out, assets, t2s="t2s.npz"):
    wav, sr = load_wav(str(out / "utt1.wav"))
    assert sr == 8000 and len(wav) > 0 and len(wav) % 160 == 0 and np.isfinite(wav).all()
    cfg = (out / "config.txt").read_text()
    assert str(assets / "vocoder.npz") in cfg and str(assets / t2s) in cfg


@pytest.mark.parametrize("mode", ["covosingle", "covosinx", "covomix"])
def test_monologue_cli(assets, mode, tmp_path, capsys):
    monologue_generation.main(_mode_args(assets, tmp_path, mode))
    _check_output(tmp_path, assets, MODELS[mode][0])
    assert "RTF" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["covosingle", "covosinx"])
def test_dialogue_cli_per_turn(assets, mode, tmp_path):
    """The per-turn modes: one T2S decode per turn (two turns here), then one
    flow sample per turn (covosingle) or one over both streams (covosinx)."""
    decodes = []
    gen = PT.generate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT, "generate", lambda *a, **kw: decodes.append(kw["source_ids"].shape) or gen(*a, **kw))
        dialogue_generation.main(_mode_args(assets, tmp_path, mode))
    assert len(decodes) == 2
    _check_output(tmp_path, assets, MODELS[mode][0])


@pytest.mark.parametrize("fuse_tail", [False, True], ids=["exact", "fuse_tail"])
def test_dialogue_cli_covomix(assets, fuse_tail, tmp_path):
    dialogue_generation.main(_args(assets, tmp_path, extra=["--mode", "covomix"] + (["--fuse_tail"] if fuse_tail else [])))
    _check_output(tmp_path, assets)


def _greedy_port_synthesizer(noises, *args, **kw):
    """The port CLI's Synthesizer, decoding greedily for at most MAX_LEN
    steps, its flow sampler taking the y0s in `noises` in order."""
    synth = P.load_synthesizer(*args, **kw)
    synth._gen_fn = functools.partial(PT.generate, cfg=synth.t2s_cfg, max_length=MAX_LEN, temperature=1.0,
                                      cond_scale=1.0, dtype=synth.dtype, top_k_thres=GREEDY_THRES)
    synth.flow_sample = lambda ph, cond, gen: P.Synthesizer.flow_sample(synth, ph, cond, gen,
                                                                        noise=noises.pop(0))
    return synth


def _greedy_jax_models(load_models, noises):
    """The JAX CLI's load_models, its Synthesizer decoding greedily for at
    most MAX_LEN steps and handing each flow sample's y0 to `noises`."""
    def load(args):
        synth = load_models(args)
        synth._gen_fn = jax.jit(functools.partial(JT.generate, cfg=synth.t2s_cfg, max_length=MAX_LEN,
                                                  temperature=1.0, cond_scale=1.0, dtype=synth.dtype,
                                                  top_k_thres=GREEDY_THRES))
        sample = synth._sample_fn

        def recording(params, *, key, phoneme_ids, cond, valid_len):
            y0 = jax.random.normal(key, cond.shape[:2] + (synth.acoustic_cfg.mel_dim,), jnp.float32)
            noises.append(torch.from_numpy(np.array(y0)))
            return sample(params, key=key, phoneme_ids=phoneme_ids, cond=cond, valid_len=valid_len)

        synth._sample_fn = recording
        return synth

    return load


PER_TURN_CASES = [(kind, mode) for kind in ("monologue", "dialogue") for mode in ("covosingle", "covosinx")]


@pytest.mark.parametrize("kind,mode", PER_TURN_CASES, ids=[f"{k}-{m}" for k, m in PER_TURN_CASES])
def test_per_turn_cli_matches_jax_cli(assets, kind, mode, tmp_path, monkeypatch):
    """The port's CLI against the JAX package's CLI (monologue_generation.py /
    dialogue_generation.py at the repository root, run in-process) on the
    same checkpoints, scripts and cached prompt mels, f32, greedy, the JAX
    sampler's y0 handed to the port: the same wav length, within
    WAV_INT16_TOL int16 steps."""
    import dialogue_generation as jax_dialogue
    import monologue_generation as jax_monologue

    noises = []
    monkeypatch.setattr(jax_monologue, "load_models", _greedy_jax_models(jax_monologue.load_models, noises))
    jax_main, port_main = ((jax_monologue.main, monologue_generation.main) if kind == "monologue"
                           else (jax_dialogue.main, dialogue_generation.main))
    argv = lambda out, device: _mode_args(assets, out, mode, ["--f32"], prompts="prompts_mel", device=device)
    monkeypatch.setattr(sys, "argv", [f"{kind}_generation.py", *argv(tmp_path / "jax", ())])
    with jax.default_matmul_precision("highest"):
        jax_main()
    n_flow = len(noises)
    assert n_flow == (2 if kind == "dialogue" and mode == "covosingle" else 1)
    monkeypatch.setattr(monologue_generation, "load_synthesizer",
                        functools.partial(_greedy_port_synthesizer, noises))
    port_main(argv(tmp_path / "port", ("--device", "cpu")))
    assert not noises                      # the port drew exactly the JAX sampler's y0s
    _, jwav = wavfile.read(str(tmp_path / "jax" / "utt1.wav"))
    _, pwav = wavfile.read(str(tmp_path / "port" / "utt1.wav"))
    assert jwav.dtype == pwav.dtype == np.int16 and len(pwav) == len(jwav) > 0 and np.abs(jwav).max() > 1000
    assert np.abs(pwav.astype(np.int32) - jwav.astype(np.int32)).max() <= WAV_INT16_TOL


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
    if torch.cuda.is_available():
        return
    args = [a for a in _args(assets, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        dialogue_generation.main(args)
