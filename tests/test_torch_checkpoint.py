"""Weights, prompts and the CLI of the port: the JAX package's `.npz` files
load into the port unchanged; the port's own copies of the tokenizer, wav IO
and mel frontend agree with the JAX package; the serving CLI runs end to end
on the CPU; and the port imports neither jax nor covomix_tpu."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.audio import mel as JM
from covomix_tpu.checkpoint import io as jio
from covomix_tpu.data import tokenizer as JTok
from covomix_tpu_torch.audio import mel as PM
from covomix_tpu_torch.audio.wav import load_wav, save_wav
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.data import tokenizer as PTok
from covomix_tpu_torch.models import vocoder as PV
from covomix_tpu_torch.pipeline import extract_mel, load_checkpoint, prepare_prompt

from _torch_port import J_AC, J_T2S, J_VOC, jax_params, tree_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree):
    return {k: np.asarray(v) for k, v in jio._flatten(tree).items()}


def test_jax_npz_loads_into_port(tmp_path):
    """JAX save_params -> port load_params -> params_from_numpy: same names,
    shapes and values (lists stay lists, f32 stays f32)."""
    for i, jp in enumerate(jax_params(0)):
        path = str(tmp_path / f"m{i}.npz")
        jio.save_params(path, jp, meta={"config": {}})
        tree = pio.load_params(path)
        tp = pio.params_from_numpy(tree, "cpu")
        assert tree_shapes(tp) == tree_shapes(jp)
        ref = _flat(jp)
        got = _flat(tp)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
            assert got[k].dtype == np.float32


def test_port_npz_loads_into_jax(tmp_path):
    """Port save_params (torch tensors) -> JAX load_params / load_meta: same
    keys, values and sidecar; the port reads its own file back unchanged."""
    for i, jp in enumerate(jax_params(1)):
        tp = pio.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        path = str(tmp_path / f"p{i}")                      # suffix added as the JAX writer adds it
        pio.save_params(path, tp, meta={"config": {"i": i}})
        assert os.path.exists(path + ".npz") and jio.load_meta(path + ".npz") == {"config": {"i": i}}
        back = jio.load_params(path + ".npz")
        assert tree_shapes(back) == tree_shapes(jp)
        ref, got = _flat(jp), _flat(back)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        assert pio._flatten(tp).keys() == jio._flatten(jp).keys()
        assert tree_shapes(pio.load_params(path + ".npz")) == tree_shapes(jp)


def test_load_checkpoint_reads_config_sidecar(tmp_path):
    """Configs come from the .json sidecar; nested lists become tuples."""
    import dataclasses

    path = str(tmp_path / "voc.npz")
    jio.save_params(path, jax_params(0)[2], meta={"config": json.loads(json.dumps(dataclasses.asdict(J_VOC)))})
    params, cfg = load_checkpoint(path, PV.VocoderConfig)
    assert cfg == PV.VocoderConfig(**dataclasses.asdict(J_VOC))
    assert cfg.resblock_dilation_sizes == ((1, 3, 5),) * 3
    hash(cfg)
    assert isinstance(params["resblocks"], list)


def test_tokenizer_copy_matches(tmp_path):
    vocab = tmp_path / "vocab.txt"
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]",
                                                             "hello", "world", "##s", "good", "morning"]
    vocab.write_text("\n".join(words) + "\n")
    texts = ["Hello worlds [laughter] good morning!", "[spkchange] héllo, WORLD", ""]
    jt = JTok.load_covomix_tokenizer(str(vocab))
    pt = PTok.load_covomix_tokenizer(str(vocab))
    for a, b in zip(jt.batch_encode(texts, max_length=8), pt.batch_encode(texts, max_length=8)):
        np.testing.assert_array_equal(a, b)
    assert PTok.remove_punctuation("Hi, there!") == JTok.remove_punctuation("Hi, there!")


def test_mel_matches_jax_and_prompt_prep(tmp_path):
    """Torch DFT-conv STFT + Slaney filterbank == the JAX frontend; a prompt
    is (codes, mel) of equal length, read through the .mel.npy cache when
    there is one."""
    rs = np.random.RandomState(0)
    wav = np.clip(rs.randn(8000) * 0.1, -1, 1).astype(np.float32)
    cfg = PM.MelConfig()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JM.mel_spectrogram(jnp.asarray(wav[None]), JM.MelConfig()))
    out = PM.mel_spectrogram(torch.from_numpy(wav[None]), cfg).numpy()
    assert out.shape == ref.shape == (1, 80, JM.mel_frames_for_samples(8000))
    assert np.abs(out - ref).max() < 1e-3   # log domain; f32 DFT sums in two orders
    np.testing.assert_allclose(PM.mel_filterbank(8000, 480, 80, 0, 4000), JM.mel_filterbank(8000, 480, 80, 0, 4000))

    save_wav(str(tmp_path / "p.wav"), wav, 8000)
    back, sr = load_wav(str(tmp_path / "p.wav"))
    assert sr == 8000 and np.abs(back - wav).max() < 1e-4
    np.save(tmp_path / "p.hubert_code.npy", np.array([str(i) for i in range(60)]))
    codes, mel = prepare_prompt(str(tmp_path / "p.hubert_code.npy"), cfg, device="cpu")
    assert codes.dtype.kind == "i" and len(codes) == len(mel) == 50 and mel.shape[1] == 80
    np.save(tmp_path / "p.mel.npy", np.zeros((80, 30), np.float32))
    codes, mel = prepare_prompt(str(tmp_path / "p.hubert_code.npy"), cfg, device="cpu")
    assert len(codes) == len(mel) == 30 and not mel.any()


def test_extract_mel_channel_and_default_device(tmp_path):
    """`channel` picks one channel of a stereo wav (the JAX Synthesizer's
    extract_mel(channel=)); with no device the mel is computed on cuda, so
    without a card the call raises instead of running on the CPU."""
    rs = np.random.RandomState(2)
    stereo = np.clip(rs.randn(4000, 2) * 0.1, -1, 1).astype(np.float32)
    save_wav(str(tmp_path / "s.wav"), stereo, 8000)
    cfg = PM.MelConfig()
    for ch in (0, 1):
        wav, _ = load_wav(str(tmp_path / "s.wav"), channel=ch)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(JM.mel_spectrogram(jnp.asarray(wav[None]), JM.MelConfig()))[0].T
        out = extract_mel(str(tmp_path / "s.wav"), cfg, device="cpu", channel=ch)
        assert out.shape == ref.shape and np.abs(out - ref).max() < 1e-3   # as the mono test above
    mono = extract_mel(str(tmp_path / "s.wav"), cfg, device="cpu")
    assert np.abs(mono - extract_mel(str(tmp_path / "s.wav"), cfg, device="cpu", channel=0)).max() > 1e-3
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        extract_mel(str(tmp_path / "s.wav"), cfg)
    np.save(tmp_path / "s.hubert_code.npy", np.arange(10))
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_prompt(str(tmp_path / "s.hubert_code.npy"), cfg)


def test_serve_batch_cli_on_cpu(tmp_path):
    """`python -m covomix_tpu_torch.serve_batch --device cpu` end to end with
    tiny npz checkpoints written by the JAX package."""
    import dataclasses

    for name, p, cfg in zip(("t2s", "ac", "voc"), jax_params(0), (J_T2S, J_AC, J_VOC)):
        jio.save_params(str(tmp_path / f"{name}.npz"), p,
                        meta={"config": json.loads(json.dumps(dataclasses.asdict(cfg)))})
    (tmp_path / "text").mkdir()
    (tmp_path / "prompt").mkdir()
    rs = np.random.RandomState(1)
    for s in ("a", "b"):
        (tmp_path / "text" / f"{s}.txt").write_text("hello world [spkchange] good morning")
        for spk in (1, 2):
            base = tmp_path / "prompt" / f"{s}_{spk}"
            np.save(f"{base}.hubert_code.npy", rs.randint(0, 500, 12))
            np.save(f"{base}.mel.npy", rs.randn(80, 10 + spk).astype(np.float32))
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "covomix_tpu_torch.serve_batch", "--t2s_ckpt", str(tmp_path / "t2s.npz"),
         "--acous_ckpt", str(tmp_path / "ac.npz"), "--hifigan_ckpt", str(tmp_path / "voc.npz"),
         "--text_dir", str(tmp_path / "text"), "--prompt_dir", str(tmp_path / "prompt"),
         "--saved_dir", str(out), "--batch", "3", "--decode_len", "16", "--max_text_tokens", "16",
         "--allow_fallback_vocab", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RTF" in res.stdout
    for s in ("a", "b"):
        wav, sr = load_wav(str(out / f"{s}.wav"))
        assert sr == 8000 and 0 < len(wav) <= 16 * 160


def test_resume_from_a_jax_train_state_names_it(tmp_path):
    """A step directory the JAX package wrote (orbax, no state.npz) counts as
    the newest step, and resuming from it raises an error that names it as a
    JAX checkpoint and gives the converter's command line for it: in
    load_train_state, in hifigan_train's automatic resume and in the train
    CLI's --resume."""
    from covomix_tpu_torch import hifigan_train as HT
    from covomix_tpu_torch.train import cli

    from test_torch_hifigan_train import write_assets
    from test_torch_train_cli import TINY, _write_items

    said = r"step_00000005 is a JAX \(orbax\) train-state checkpoint.*python convert_jax_train_state.py .*step_00000005"
    hifi, logs = tmp_path / "hifi", tmp_path / "logs"
    write_assets(str(hifi))
    for ckpt in (hifi / "cp", logs / "vomix" / "checkpoints"):
        jio.save_train_state(str(ckpt), {"params": {"w": jnp.ones(3)}, "step": jnp.int32(5)}, 5)
        assert pio.latest_step(str(ckpt)) == 5
        with pytest.raises(ValueError, match=said):
            pio.load_train_state(str(ckpt), 5, None)
    with pytest.raises(ValueError, match=said):
        HT.main(["--input_wavs_dir", str(hifi / "wavs"), "--config", str(hifi / "config.json"), "--checkpoint_path",
                 str(hifi / "cp"), "--device", "cpu"])
    _write_items(str(tmp_path / "data"), "hubert_fisher", 3)
    with pytest.raises(ValueError, match=said):
        cli.main(["--base_dir", str(tmp_path / "data"), "--device", "cpu", *TINY, "--batch_size", "2",
                  "--log_dir", str(logs), "--run_name", "vomix", "--resume", "--no_wandb"])


def test_port_imports_neither_jax_nor_reference_package():
    """Every port module and chip_smoke.py import with jax, covomix_tpu and
    joblib / scikit-learn (which only `load_kmeans` needs, inside the call)
    blocked; chip_smoke.py without a card exits non-zero and prints no
    result."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "covomix_tpu", "joblib", "sklearn"):
            sys.modules[name] = None          # any import of them raises ImportError
        sys.path.insert(0, {REPO!r})
        import covomix_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(covomix_tpu_torch.__path__, "covomix_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        assert len(mods) >= 50, mods
        for m in ("checkpoint.torch_convert", "convert_checkpoint", "hifigan_inference", "util.metrics",
                  "util.pesq_nb", "data.batching", "models.hubert", "extract_semantic_tokens", "util.profiling",
                  "train.gan", "hifigan_train", "data.prefetch", "parallel.mesh", "parallel.multihost",
                  "parallel.train_step"):
            assert "covomix_tpu_torch." + m in mods, m
        print("imported", len(mods))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr[-2000:]
    # imports inside functions too (chip_smoke.py imports lazily)
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "covomix_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "covomix_tpu"), f"{path} imports {n}"
    if not torch.cuda.is_available():
        smoke = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True,
                               text=True, timeout=120)
        assert smoke.returncode != 0 and '"ok"' not in smoke.stdout
