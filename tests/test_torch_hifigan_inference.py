"""The port's HiFi-GAN inference CLI (`python -m covomix_tpu_torch.hifigan_inference
--device cpu`) against the JAX package's generator: from a tiny `.npz` and
from a `g_<step>` + vocoder_config.json, copy synthesis (with the metrics
CSV) and mel -> wav, with exact-length vocoding (valid_len) and with
--fuse_tail (the fused stage / tail's plain versions on the CPU against
the JAX generator's unfused convs over the same bucket-padded mel). The
written int16 wavs equal JAX's within one step."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.checkpoint import io as jio
from covomix_tpu.checkpoint import torch_convert as jtc
from covomix_tpu.models import vocoder as JV
from covomix_tpu_torch import hifigan_inference as HI
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram, save_wav

import _torch_ckpt as CK
from _torch_port import J_VOC, jax_params

SECONDS = (1.0, 1.37)    # 51 and 70 mel frames: buckets of 64 and 128
COLUMNS = ["file", "pesq_nb_approx", "si_snr", "stoi", "estoi", "mcd_db", "rtf"]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("hifigan_inference")
    tree = jax.tree_util.tree_map(np.asarray, jax_params(0)[2])
    jio.save_params(str(root / "voc.npz"), tree, meta={"config": {"upsample_initial_channel": 16}})
    (root / "torch").mkdir()
    CK.write_hifigan_ckpt(str(root / "torch" / "g_00000100"), tree, J_VOC)
    (root / "wavs").mkdir()
    (root / "mels").mkdir()
    rs = np.random.RandomState(0)
    for i, s in enumerate(SECONDS):
        t = np.arange(int(8000 * s)) / 8000
        wav = 0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
            + 0.01 * rs.randn(len(t))
        save_wav(str(root / "wavs" / f"u{i}.wav"), wav.astype(np.float32), 8000)
        np.save(root / "mels" / f"m{i}.npy", rs.randn(80, 30 + 41 * i).astype(np.float32) - 5)
    return root


def _jax_params(assets, ckpt):
    if ckpt == "npz":
        return jio.load_params(str(assets / "voc.npz"))
    return jtc.convert_hifigan_ckpt(str(assets / "torch" / "g_00000100"), {})


def _jax_wav(params, mel, fuse_tail):
    """JAX generator on mel [1, T, 80] bucketed as the CLI buckets it."""
    t = mel.shape[1]
    tb = -(-t // 64) * 64
    mel = np.pad(mel, ((0, 0), (0, tb - t), (0, 0)), constant_values=-15.0)
    with jax.default_matmul_precision("highest"):
        if fuse_tail:
            out = JV.generator(params, J_VOC, jnp.asarray(mel), fuse_tail=False)
        else:
            out = JV.generator(params, J_VOC, jnp.asarray(mel), fuse_tail=False, valid_len=jnp.int32(t))
    return np.asarray(out)[0, : JV.output_length(J_VOC, t)]


def _as_int16(wav):
    return (np.clip(wav, -1, 1) * 32768.0).astype(np.int16)


def _ckpt_args(assets, ckpt):
    return ["--checkpoint_file", str(assets / "voc.npz") if ckpt == "npz" else str(assets / "torch" / "g_00000100")]


@pytest.mark.parametrize("fuse_tail", [False, True], ids=["exact", "fuse_tail"])
@pytest.mark.parametrize("ckpt", ["npz", "g"])
def test_copy_synthesis_matches_jax(assets, tmp_path, ckpt, fuse_tail, capsys):
    out = tmp_path / "out"
    HI.main(_ckpt_args(assets, ckpt) + ["--input_wavs_dir", str(assets / "wavs"), "--output_dir", str(out),
                                        "--metrics_csv", str(tmp_path / "m.csv"), "--device", "cpu"]
            + (["--fuse_tail"] if fuse_tail else []))
    params = _jax_params(assets, ckpt)
    for i, s in enumerate(SECONDS):
        wav, _ = load_wav(str(assets / "wavs" / f"u{i}.wav"))
        mel = mel_spectrogram(torch.from_numpy(wav[None]), MelConfig())[0].T.numpy()[None]   # the CLI's mel
        ref = _as_int16(_jax_wav(params, mel, fuse_tail))
        from scipy.io import wavfile

        sr, got = wavfile.read(str(out / f"u{i}_generated.wav"))
        assert sr == 8000 and got.dtype == np.int16 and len(got) == JV.output_length(J_VOC, mel.shape[1])
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    with open(tmp_path / "m.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["file"] for r in rows] == ["u0.wav", "u1.wav"] and list(rows[0]) == COLUMNS
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in COLUMNS[1:]), r
    assert "mean:" in capsys.readouterr().out


@pytest.mark.parametrize("fuse_tail", [False, True], ids=["exact", "fuse_tail"])
def test_mels_to_wav_matches_jax(assets, tmp_path, fuse_tail):
    """--input_mels_dir: [80, T] mel files (transposed on read) -> wavs."""
    HI.main(_ckpt_args(assets, "g") + ["--input_mels_dir", str(assets / "mels"), "--output_dir", str(tmp_path),
                                       "--device", "cpu"] + (["--fuse_tail"] if fuse_tail else []))
    params = _jax_params(assets, "g")
    from scipy.io import wavfile

    for i in range(2):
        mel = np.load(assets / "mels" / f"m{i}.npy").T[None]
        ref = _as_int16(_jax_wav(params, mel, fuse_tail))
        sr, got = wavfile.read(str(tmp_path / f"m{i}_generated_e2e.wav"))
        assert len(got) == len(ref) and np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_config_overlay_and_default_device(assets, tmp_path):
    """--config overlays an .npz sidecar (here the mel analysis keys); the
    CLI asks for cuda by default and raises where there is none."""
    _, c = HI.load_vocoder(str(assets / "voc.npz"), str(assets / "torch" / "vocoder_config.json"))
    assert c["upsample_initial_channel"] == 16 and c["sampling_rate"] == 8000
    assert HI.mel_config({"hop_size": 80, "fmax": 3000}, 8000, 80) == MelConfig(8000, 480, 80, 80, 480, 0.0, 3000.0)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        HI.main(_ckpt_args(assets, "npz") + ["--input_wavs_dir", str(assets / "wavs"), "--output_dir",
                                             str(tmp_path)])
    assert not os.listdir(tmp_path)
