"""The port's oracle pairing (covomix_tpu_torch/data/oracle.py) and its
file-level evals (train/evaluate.py `evaluate_*_files`) against the JAX
package: the same `random.Random` seed gives the same prompts, partners and
crops bit for bit, and on the same files and weights, with JAX's per-file
y0 handed to the port, the evals give the same 'l2' (f32 within 1e-4
relative; the T2S eval, greedy on both sides, equal)."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.data import oracle as JO
from covomix_tpu.data import tokenizer as JTok
from covomix_tpu.models import acoustic as JA, text2semantic as JT
from covomix_tpu.train import evaluate as JE
from covomix_tpu_torch.data import oracle as PO
from covomix_tpu_torch.data import tokenizer as PTok
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT
from covomix_tpu_torch.train import evaluate as PE

from _torch_port import GREEDY_THRES, J_T2S, port_cfg, to_port

J_CFGS = {
    "single": JA.AcousticConfig(dim_in=80, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                                num_phoneme_tokens=502),
    "two_one": JA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                                 num_phoneme_tokens=502, mode="two_one"),
    "two_two": JA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                                 num_phoneme_tokens=502, mode="two_two"),
}
EVALS = {"single": (JE.evaluate_acoustic_files, PE.evaluate_acoustic_files),
         "two_one": (JE.evaluate_acoustic_two_one_files, PE.evaluate_acoustic_two_one_files),
         "two_two": (JE.evaluate_acoustic_two_two_files, PE.evaluate_acoustic_two_two_files)}


def _write_utt(d, name, frames, seed, mixed=True):
    """`name.mel.npy` (unless not `mixed`) with its codes, and the -A / -B
    stream mels with '-16k' codes, a few frames apart in length."""
    rs = np.random.RandomState(seed)
    base = os.path.join(d, name)
    if mixed:
        np.save(base + ".mel.npy", rs.randn(80, frames).astype(np.float32))
        np.save(base + ".hubert_code.npy", rs.randint(0, 500, frames - 3).astype(str))
    for suf, extra in (("-A", 0), ("-B", 5)):
        np.save(base + suf + ".mel.npy", rs.randn(80, frames + extra).astype(np.float32))
        np.save(base + suf + "-16k.hubert_code.npy", rs.randint(0, 500, frames + 2 * extra).astype(str))
    return base + ".mel.npy"


@pytest.fixture(scope="module")
def mel_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("oracle"))
    files = [_write_utt(d, f"{spk}-{k:02d}", 300 + 37 * k + 11 * s, seed=10 * s + k, mixed=(s, k) != (0, 2))
             for s, spk in enumerate(("fe_03_00001", "fe_03_00002", "fe_03_00003")) for k in range(3)]
    return sorted(files)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_pairing_matches_jax(mel_files, seed):
    with_mixed = [f for f in mel_files if os.path.isfile(f)]
    for i in range(len(mel_files)):
        for fn in ("choose_prompt", "choose_different_spk"):
            assert getattr(PO, fn)(mel_files, i, random.Random(seed)) == getattr(JO, fn)(mel_files, i,
                                                                                       random.Random(seed))
    for i in range(len(with_mixed)):
        for shuffle in (False, True):
            jr, pr = random.Random(seed + i), random.Random(seed + i)
            ref = JO.prepare_oracle_example_with_prompt(with_mixed, i, rng=jr, shuffle_spec=shuffle)
            got = PO.prepare_oracle_example_with_prompt(with_mixed, i, rng=pr, shuffle_spec=shuffle)
            assert all(_equal(g, r) for g, r in zip(got, ref)) and jr.random() == pr.random()
    for path in mel_files:
        path_a = path.replace(".mel.npy", "-A.mel.npy")
        for partner in (None, mel_files):
            jr, pr = random.Random(seed), random.Random(seed)
            ref = JO.load_two_stream_example(path_a, rng=jr, random_partner=partner)
            got = PO.load_two_stream_example(path_a, rng=pr, random_partner=partner)
            assert all(_equal(g, r) for g, r in zip(got, ref)), (path, partner is None)
            assert (got[2] is None) == (partner is not None or not os.path.isfile(path))
    assert PE._uniform_indices(9, 4) == JE._uniform_indices(9, 4) and PE._uniform_indices(0, 3) == []
    for arr, pad in ((np.arange(130, dtype=np.int32), 501), (np.ones((5, 3), np.float32), 0.0)):
        assert _equal(PE._pad_bucket(arr, 128, pad), JE._pad_bucket(arr, 128, pad))


def _jax_noise_recorder(monkeypatch, noises):
    """JA.sample draws its y0 as usual and also hands it to `noises` (in
    call order) through a debug callback, so it works under jit."""
    j_sample = JA.sample

    def recording(params, cfg, key, phoneme_ids, cond, **kw):
        y0 = jax.random.normal(key, cond.shape[:2] + (cfg.mel_dim,), jnp.float32)
        jax.debug.callback(lambda n: noises.append(np.asarray(n).copy()), y0)
        return j_sample(params, cfg, key, phoneme_ids, cond, **kw)

    monkeypatch.setattr(JA, "sample", recording)


@pytest.mark.parametrize("mode", list(J_CFGS))
def test_file_level_acoustic_evals_match_jax(mel_files, monkeypatch, mode):
    jcfg = J_CFGS[mode]
    pcfg = port_cfg(PA.AcousticConfig, jcfg)
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    j_eval, p_eval = EVALS[mode]
    if mode == "single":    # VoSingle reads each file's own mel
        mel_files = [f for f in mel_files if os.path.isfile(f)]
    noises = []
    _jax_noise_recorder(monkeypatch, noises)
    with jax.default_matmul_precision("highest"):
        ref = j_eval(jp, jcfg, mel_files, 4, jax.random.PRNGKey(5))
    n_files = len(noises)
    assert n_files == (3 if mode == "two_one" else 4)   # two_one skips the file without a mixed mel
    p_sample = PA.sample
    monkeypatch.setattr(PA, "sample", lambda *a, **kw: p_sample(*a, **kw, noise=torch.from_numpy(noises.pop(0))))
    got = p_eval(to_port(jp), pcfg, mel_files, 4, torch.Generator().manual_seed(0))
    assert not noises and got.keys() == ref.keys() == {"l2"}
    assert np.isfinite(got["l2"]) and got["l2"] > 0
    assert got["l2"] == pytest.approx(float(ref["l2"]), rel=1e-4)


def test_file_level_t2s_eval_matches_jax(tmp_path, monkeypatch):
    """The `.txt` lookup of each codes name form, the 501-padded WER, greedy
    decodes on both sides: the same 'l2'."""
    rs = np.random.RandomState(2)
    files = []
    for k, (code_name, txt) in enumerate((("a-16k.hubert_code.npy", "a.txt"), ("b_1.hubert_code.npy", "b.txt"),
                                          ("c.hubert_code.npy", "c.txt"), ("d-16k.hubert_code.npy", "d.txt"))):
        np.save(str(tmp_path / code_name), rs.randint(0, 500, 12 + 5 * k).astype(str))
        (tmp_path / txt).write_text(["hello there [laughter] yes", "oh right", "so what do you do",
                                     "[spkchange] yeah i know"][k] + "\n")
        files.append(str(tmp_path / code_name))
    jtok = JTok.load_covomix_tokenizer(None, strict=False)
    ptok = PTok.load_covomix_tokenizer(None, strict=False)
    jp = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(4), J_T2S)
    jgen, pgen = JT.generate, PT.generate
    monkeypatch.setattr(JT, "generate", lambda *a, **kw: jgen(*a, **{**kw, "top_k_thres": GREEDY_THRES}))
    monkeypatch.setattr(PT, "generate", lambda *a, **kw: pgen(*a, **{**kw, "top_k_thres": GREEDY_THRES}))
    with jax.default_matmul_precision("highest"):
        ref = JE.evaluate_t2s_files(jp, J_T2S, jtok, files, 4, jax.random.PRNGKey(0), max_length=40)
    got = PE.evaluate_t2s_files(to_port(jp), port_cfg(PT.T2SConfig, J_T2S), ptok, files, 4,
                                torch.Generator().manual_seed(0), max_length=40)
    assert got.keys() == ref.keys() == {"l2"}
    assert got["l2"] == pytest.approx(float(ref["l2"]), abs=1e-12) and 0 < got["l2"] <= 1
