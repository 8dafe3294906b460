"""The port's semantic-token extraction: `data/batching.batch_by_size`
against the JAX package's `native.batch_by_size` (its C++ helper and its
Python fallback), and `python -m covomix_tpu_torch.extract_semantic_tokens
--device cpu` at a narrow HuBERT (the full conv stack's kernels and strides,
so the CLI's 5 s buckets give 249-frame batches; width 32, 2 layers): the
string arrays it writes equal per-file `wav2units` of the port and
exact-length `wav2units_jit` of the JAX package."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu import native as JN
from covomix_tpu.models import hubert as JH
from covomix_tpu_torch import extract_semantic_tokens as EST
from covomix_tpu_torch.audio import save_wav
from covomix_tpu_torch.checkpoint.io import save_params
from covomix_tpu_torch.data.batching import batch_by_size
from covomix_tpu_torch.models import hubert as PH

import _torch_port  # noqa: F401  (one torch thread beside the XLA client)

PCFG = PH.HubertConfig(conv_layers=tuple((32, k, s) for _, k, s in PH.HubertConfig().conv_layers), encoder_layers=2,
                       encoder_embed_dim=32, encoder_ffn_dim=64, encoder_heads=4, conv_pos=16, conv_pos_groups=4,
                       output_layer=2, num_units=11)
JCFG = JH.HubertConfig(**dataclasses.asdict(PCFG))
FILES = {"a/x.wav": 1.2, "a/y.wav": 3.0, "b/x.wav": 5.5, "c.wav": 0.7}   # same names in two dirs


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "python_fallback"])
@pytest.mark.parametrize("max_tokens,max_sentences", [(0, 0), (1000, 0), (0, 3), (700, 4), (16000 * 120, 16)])
def test_batch_by_size_equals_jax(monkeypatch, native, max_tokens, max_sentences):
    if not native:
        monkeypatch.setattr(JN, "_lib", False)
    elif not JN.native_available():
        pytest.fail("the JAX package's native library did not build")
    rs = np.random.RandomState(max_tokens + max_sentences)
    for n in (0, 1, 7, 60):
        lengths = rs.randint(1, 400, n)
        lengths[: n // 4] = 200        # ties: the sort is stable
        ref = JN.batch_by_size(lengths, max_tokens=max_tokens, max_sentences=max_sentences)
        got = batch_by_size(lengths, max_tokens=max_tokens, max_sentences=max_sentences)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("est")
    params = PH.init(torch.Generator().manual_seed(0), PCFG)
    save_params(str(root / "hubert.npz"), params, meta={"kind": "hubert", "config": {}})
    rs = np.random.RandomState(0)
    for rel, s in FILES.items():
        os.makedirs(os.path.dirname(root / "wavs" / rel), exist_ok=True)
        save_wav(str(root / "wavs" / rel), (0.2 * rs.randn(int(16000 * s))).astype(np.float32), 16000)
    return root, params


def _run(assets, out, monkeypatch, extra=()):
    root, _ = assets
    monkeypatch.setattr(EST.H, "HubertConfig", lambda: PCFG)
    EST.main(["--data_dir", str(root / "wavs"), "--hubert_ckpt", str(root / "hubert.npz"), "--out_dir", str(out),
              "--batch_tokens", str(16000 * 8), "--device", "cpu", *extra])


def test_cli_equals_per_file_wav2units(assets, tmp_path, monkeypatch, capsys):
    """Several batches (0.7 + 1.2 s, then 3 s and 5.5 s alone), each padded to
    a 5 s multiple; --out_dir mirrors the subpaths."""
    root, params = assets
    _run(assets, tmp_path, monkeypatch)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    from covomix_tpu_torch.audio import load_wav

    for rel in FILES:
        codes = np.load(tmp_path / rel.replace(".wav", ".hubert_code.npy"))
        assert codes.dtype.kind == "U"
        wav, _ = load_wav(str(root / "wavs" / rel), sr=16000)
        assert len(codes) == PH.num_output_frames(PCFG, len(wav))
        np.testing.assert_array_equal(codes.astype(int), PH.wav2units(params, PCFG, wav), err_msg=rel)
        with jax.default_matmul_precision("highest"):
            exact = np.asarray(JH.wav2units_jit(jp, JCFG, jnp.asarray(wav[None])))[0]
        np.testing.assert_array_equal(codes.astype(int), exact, err_msg=rel)
    out = capsys.readouterr().out
    assert "4 wavs" in out and "tokens/s" in out and "x realtime" in out


def test_cli_bf16_and_next_to_wavs(assets, tmp_path, monkeypatch):
    """--bf16 writes ids of the right count and range; without --out_dir
    the codes go next to each wav."""
    root, _ = assets
    import shutil

    shutil.copytree(root / "wavs", tmp_path / "wavs")
    monkeypatch.setattr(EST.H, "HubertConfig", lambda: PCFG)
    EST.main(["--data_dir", str(tmp_path / "wavs"), "--hubert_ckpt", str(root / "hubert.npz"), "--bf16",
              "--device", "cpu"])
    for rel, s in FILES.items():
        codes = np.load(tmp_path / "wavs" / rel.replace(".wav", ".hubert_code.npy")).astype(int)
        assert len(codes) == PH.num_output_frames(PCFG, int(16000 * s)) and ((0 <= codes) & (codes < 11)).all()


def test_cli_default_device_is_cuda(assets, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        EST.main(["--data_dir", str(tmp_path)])
