"""The port's data preparation against the JAX package: `python -m
covomix_tpu_torch.prepare_mels --device cpu` against
data_preparation/prepare_mels.py (the same file tree, mels within 1e-4),
`python -m covomix_tpu_torch.evaluate_metrics --device cpu` against
evaluate_metrics.py (the same rows, numbers within 1e-3), and the helpers
they and the duration-predicting T2S data path use (`mel_frames_for_samples`,
`stft_magnitude`, util/misc, `compress_token_runs`,
`collate_t2s_duration`)."""

import csv
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.audio import mel as JM
from covomix_tpu.data import datasets as JD, tokenizer as JTok
from covomix_tpu.util import misc as JU
from covomix_tpu_torch import evaluate_metrics
from covomix_tpu_torch.audio import mel as PM, save_wav
from covomix_tpu_torch.data import datasets as PD, tokenizer as PTok
from covomix_tpu_torch.util import misc as PU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000


def _jax_cli(script, args, cwd):
    return subprocess.run([sys.executable, os.path.join(REPO, script), *args], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=dict(os.environ, COVOMIX_FORCE_CPU="1"))


def _port_cli(module, args, cwd):
    return subprocess.run([sys.executable, "-m", f"covomix_tpu_torch.{module}", "--device", "cpu", *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO if cwd is None else cwd,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def _mels(root):
    return {os.path.relpath(os.path.join(d, n), root): np.load(os.path.join(d, n))
            for d, _, names in os.walk(root) for n in names if n.endswith(".mel.npy")}


def test_prepare_mels_matches_jax(tmp_path):
    """Seeded wavs in two subdirectories (one name in both, lengths across
    the 5 s bucket): with --save_path the subpaths mirror, without it the
    mels land next to the wavs; every mel of the port within 1e-4 of JAX's."""
    rs = np.random.RandomState(0)
    wavs = tmp_path / "wavs"
    for sub, secs in (("a", (1.3, 6.1, 3.7)), ("b", (2.05, 5.0))):
        (wavs / sub).mkdir(parents=True)
        for k, s in enumerate(secs):
            n = int(s * SR)
            w = 0.3 * np.sin(np.arange(n) * (0.01 + 0.003 * k)) + 0.05 * rs.randn(n)
            save_wav(str(wavs / sub / f"u{k}.wav"), w.astype(np.float32), SR)
    beside = tmp_path / "beside"
    shutil.copytree(wavs, beside)
    runs = [_jax_cli("data_preparation/prepare_mels.py", ["--data_path", str(wavs), "--save_path",
                                                          str(tmp_path / "out_jax")], str(tmp_path)),
            _port_cli("prepare_mels", ["--data_path", str(wavs), "--save_path", str(tmp_path / "out_port")], None),
            _port_cli("prepare_mels", ["--data_path", str(beside)], None)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    for got_root in (tmp_path / "out_port", beside):
        ref, got = _mels(tmp_path / "out_jax"), _mels(got_root)
        assert sorted(got) == sorted(ref) and len(got) == 5, (sorted(got), sorted(ref))
        for name in ref:
            assert got[name].shape == ref[name].shape and got[name].dtype == np.float32, name
            assert np.abs(got[name] - ref[name]).max() < 1e-4, name
    assert os.path.isfile(tmp_path / "out_port" / "b" / "u0.mel.npy")
    assert os.path.isfile(beside / "a" / "u2.mel.npy") and os.path.isfile(beside / "a" / "u2.wav")


def _csv(path):
    rows, trailer = [], []
    with open(path) as f:
        for line in f:
            (trailer if line.startswith("#") else rows).append(line)
    return list(csv.DictReader(rows)), trailer


def test_evaluate_metrics_matches_jax(tmp_path):
    """Pairs matched by basename with the `_generated` rule, unmatched files
    skipped; the same rows, every number within 1e-3, and the `# key: m +- s`
    trailer; no matched pair exits 1."""
    rs = np.random.RandomState(1)
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    gen.mkdir(), ref.mkdir()
    for k, name in enumerate(("a", "b", "c")):
        n = SR + 900 * k
        w = (0.2 * np.sin(np.arange(n) * 0.02 * (k + 1)) + 0.05 * rs.randn(n)).astype(np.float32)
        save_wav(str(ref / f"{name}.wav"), w, SR)
        g = w[: n - 300 * k] + 0.02 * rs.randn(n - 300 * k).astype(np.float32)
        save_wav(str(gen / (f"{name}_generated.wav" if k != 1 else f"{name}.wav")), g, SR)
    save_wav(str(gen / "orphan.wav"), rs.randn(SR).astype(np.float32) * 0.1, SR)
    r = _jax_cli("evaluate_metrics.py", ["--gen_dir", str(gen), "--ref_dir", str(ref), "--out_csv",
                                         str(tmp_path / "jax.csv")], str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    r = _port_cli("evaluate_metrics", ["--gen_dir", str(gen), "--ref_dir", str(ref), "--out_csv",
                                       str(tmp_path / "port.csv")], None)
    assert r.returncode == 0, r.stderr[-2000:]
    (jrows, jtrail), (prows, ptrail) = _csv(tmp_path / "jax.csv"), _csv(tmp_path / "port.csv")
    assert [row["file"] for row in prows] == [row["file"] for row in jrows] == ["a.wav", "b.wav", "c.wav"]
    assert list(prows[0]) == list(jrows[0])
    for pr, jr in zip(prows, jrows):
        for key in jr:
            if key != "file":
                assert abs(float(pr[key]) - float(jr[key])) <= 1e-3, (pr["file"], key, pr[key], jr[key])
    assert len(ptrail) == len(jtrail) == 5
    for pl, jl in zip(ptrail, jtrail):
        (pk, pv), (jk, jv) = pl.split(":"), jl.split(":")
        assert pk == jk and all(abs(float(a) - float(b)) <= 1e-3 for a, b in zip(pv.split("+-"), jv.split("+-")))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as exit_info:
        evaluate_metrics.main(["--gen_dir", str(empty), "--ref_dir", str(ref), "--out_csv", str(tmp_path / "none.csv"),
                               "--device", "cpu"])
    assert exit_info.value.code == 1 and not os.path.exists(tmp_path / "none.csv")


def test_mel_helpers_match_jax():
    cfg_j, cfg_p = JM.MelConfig(), PM.MelConfig()
    for n in (0, 1, 159, 160, 480, 8000, 12345):
        assert PM.mel_frames_for_samples(n, cfg_p) == JM.mel_frames_for_samples(n, cfg_j)
    y = np.random.RandomState(2).randn(3, 4001).astype(np.float32) * 0.3
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JM.stft_magnitude(jnp.asarray(y), cfg_j))
    got = PM.stft_magnitude(torch.from_numpy(y), cfg_p).numpy()
    assert got.shape == ref.shape == (3, 241, PM.mel_frames_for_samples(4001))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    with jax.default_matmul_precision("highest"):
        ref_mel = np.asarray(JM.mel_spectrogram(jnp.asarray(y), cfg_j))
    assert np.abs(PM.mel_spectrogram(torch.from_numpy(y), cfg_p).numpy() - ref_mel).max() < 1e-4


def test_misc_helpers_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    data = rs.randn(20)
    data[[2, 7]] = np.nan
    assert PU.mean_std(data) == JU.mean_std(data)
    for t in (64, 65, 100):
        spec = rs.randn(2, 80, t).astype(np.float32)
        assert np.array_equal(PU.pad_spec(spec, 64, -1.5), JU.pad_spec(spec, 64, -1.5))
    arr = np.zeros((3, 4, 5))
    for x in (2.0, np.arange(3)):
        assert np.array_equal(PU.batch_broadcast(x, arr), JU.batch_broadcast(x, arr))
    f0 = np.array([0, 0, 120.0, 130, 0, 0, 150, 0], np.float32)
    hp = {"f0_mean": 130.0, "f0_std": 20.0}
    for a, b in zip(PU.process_f0(f0, hp), JU.process_f0(f0, hp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pitch, uv = JU.process_f0(f0, hp)
    pitch[-1] = -200
    for kw in ({}, {"min": 125.0, "max": 140.0}):
        assert np.array_equal(PU.restore_pitch(pitch, uv, hp, **kw), JU.restore_pitch(pitch, uv, hp, **kw))
    xs = np.zeros((3, 2, 6))
    for args in (([2, 6, 4],), ([2, 6, 4], xs), ([1, 2, 0], xs, 1)):
        assert np.array_equal(PU.make_pad_mask(*args), JU.make_pad_mask(*args))
        assert np.array_equal(PU.make_non_pad_mask(*args), JU.make_non_pad_mask(*args))
    with pytest.raises(ValueError):
        PU.make_pad_mask([1, 2], xs, 0)
    assert np.array_equal(PU.get_mask_from_lengths([3, 1, 5]), JU.get_mask_from_lengths([3, 1, 5]))
    reg = PU.Registry("model")
    reg.register("b")(int)
    reg.register("a")(str)
    assert reg.get_by_name("a") is str and reg.get_all_names() == ["a", "b"]
    with pytest.raises(ValueError, match="unknown model"):
        reg.get_by_name("c")
    PU.ensure_dir(str(tmp_path / "x" / "y"))
    PU.ensure_dir(str(tmp_path / "x" / "y"))
    assert os.path.isdir(tmp_path / "x" / "y")


@pytest.mark.parametrize("tokens", [np.array([7, 7, 7, 3, 3, 9]), np.stack([[5, 5, 5, 5], [1, 2, 2, 3]], axis=1),
                                    np.zeros((0,), np.int64), np.random.RandomState(4).randint(0, 3, (50, 2))],
                         ids=["one", "two", "empty", "random"])
def test_compress_token_runs_matches_jax(tokens):
    for got, ref in zip(PD.compress_token_runs(tokens), JD.compress_token_runs(tokens)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("streams", [1, 2])
def test_collate_t2s_duration_matches_jax(streams):
    rs = np.random.RandomState(5 + streams)
    shape = (lambda n: (n,)) if streams == 1 else (lambda n: (n, 2))
    items = [{"text": t, "semantic": rs.randint(0, 4, shape(n)).astype(np.int32)}
             for t, n in (("hello there", 30), ("[laughter] yes right", 71), ("oh", 5))]
    ref = JD.collate_t2s_duration(items, JTok.load_covomix_tokenizer(None, strict=False), bucket=16)
    got = PD.collate_t2s_duration(items, PTok.load_covomix_tokenizer(None, strict=False), bucket=16)
    assert got.keys() == ref.keys() == {"text_ids", "semantic_ids", "durations"}
    for key in ref:
        assert got[key].dtype == ref[key].dtype and np.array_equal(got[key], ref[key]), key
    assert got["semantic_ids"].ndim == streams + 1


@pytest.mark.parametrize("cli", ["prepare_mels", "evaluate_metrics"])
def test_clis_default_to_cuda_and_raise_without_it(tmp_path, cli):
    from covomix_tpu_torch import prepare_mels

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    main = {"prepare_mels": prepare_mels.main, "evaluate_metrics": evaluate_metrics.main}[cli]
    argv = (["--data_path", str(tmp_path)] if cli == "prepare_mels"
            else ["--gen_dir", str(tmp_path), "--ref_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
