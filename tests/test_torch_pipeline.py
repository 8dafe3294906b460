"""The port's per-file Synthesizer against the JAX package's Synthesizer on
the same weights, prompts and noise: covosingle / covosinx / covomix, in
monologue and dialogue, with and without `fuse_tail`.

Both sides decode greedily (each Synthesizer's T2S stage is swapped for a
k = 1 partial of its package's `generate`), the port is handed the y0 that the
JAX flow sampler draws from its key, and the prompts carry `.mel.npy` caches
so both read the same prompt mel. f32 at 'highest' precision: tokens equal,
wav within 1e-4 (the flow's 32 evaluations and the vocoder's conv stack carry
summation-order differences of ~1e-6 into a ~0.1-scale wav)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.audio import save_wav
from covomix_tpu.data.tokenizer import COVOMIX_ADDED_TOKENS, WordPieceTokenizer as JTok
from covomix_tpu.models import acoustic as JA, text2semantic as JT, vocoder as JV
from covomix_tpu.pipeline import Synthesizer as JSynth
from covomix_tpu_torch.data.tokenizer import WordPieceTokenizer as PTok
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV
from covomix_tpu_torch.pipeline import Synthesizer as PSynth

from _torch_port import GREEDY_THRES, port_cfg

MAX_LEN = 16
BUCKET = 128      # every flow / vocode length of these tests fits one bucket: one compile per stage
WAV_TOL = 1e-4

J_SINGLE = JT.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16, num_text_tokens=200,
                        num_semantic_tokens=501, target_dim=32)
J_COMIX = JT.T2SConfig(**{**J_SINGLE.__dict__, "two_output": True})
J_VOSINGLE = JA.AcousticConfig(dim_in=80, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                               num_phoneme_tokens=502)
J_VOMIX = JA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                            num_phoneme_tokens=502, mode="two_one")
J_VOC = JV.VocoderConfig(upsample_initial_channel=16)
# mode -> (T2S, acoustic) model names, as tests/test_pipeline.py pairs them
MODELS = {"covosingle": ("single", "vosingle"), "covosinx": ("single", "vomix"), "covomix": ("comix", "vomix")}
CONFIGS = {"single": J_SINGLE, "comix": J_COMIX, "vosingle": J_VOSINGLE, "vomix": J_VOMIX}


def _numpy_params(seed):
    """name -> parameters of every tiny model, drawn by the port's init
    (numpy trees; faster on the CPU than JAX's per-shape random compiles)."""
    g = torch.Generator().manual_seed(seed)
    inits = {"single": (PT.init, PT.T2SConfig), "comix": (PT.init, PT.T2SConfig),
             "vosingle": (PA.init, PA.AcousticConfig), "vomix": (PA.init, PA.AcousticConfig),
             "voc": (PV.init_generator, PV.VocoderConfig)}
    cfgs = {**CONFIGS, "voc": J_VOC}
    return {name: jax.tree_util.tree_map(lambda t: t.numpy(), init(g, port_cfg(cls, cfgs[name])))
            for name, (init, cls) in inits.items()}


@pytest.fixture(scope="module")
def synths():
    """mode -> (JAX Synthesizer, port Synthesizer) on the same weights, both
    with a greedy T2S stage."""
    params = _numpy_params(0)
    voc = params["voc"]
    out = {}
    for mode, (t2s_name, ac_name) in MODELS.items():
        tc, acfg = CONFIGS[t2s_name], CONFIGS[ac_name]
        js = JSynth(params[t2s_name], tc, params[ac_name], acfg, voc, J_VOC, JTok(None, added_tokens=COVOMIX_ADDED_TOKENS),
                    bucket=BUCKET, t2s_max_length=MAX_LEN)
        js._gen_fn = jax.jit(functools.partial(JT.generate, cfg=tc, max_length=MAX_LEN, temperature=1.0,
                                               cond_scale=1.0, dtype=jnp.float32, top_k_thres=GREEDY_THRES))
        pc = port_cfg(PT.T2SConfig, tc)
        ps = PSynth(params[t2s_name], pc, params[ac_name], port_cfg(PA.AcousticConfig, acfg), voc,
                    port_cfg(PV.VocoderConfig, J_VOC), PTok(None, added_tokens=COVOMIX_ADDED_TOKENS),
                    bucket=BUCKET, t2s_max_length=MAX_LEN, device="cpu")
        ps._gen_fn = functools.partial(PT.generate, cfg=pc, max_length=MAX_LEN, temperature=1.0, cond_scale=1.0,
                                       dtype=torch.float32, top_k_thres=GREEDY_THRES)
        out[mode] = (js, ps)
    return out


@pytest.fixture(scope="module")
def prompt_dir(tmp_path_factory):
    """Prompts `utt`, `dlg_1`, `dlg_2`: 1 s noise wavs, string codes, and a
    `.mel.npy` cache of each wav's mel (the JAX frontend's)."""
    from covomix_tpu.audio import MelConfig, mel_spectrogram

    d = tmp_path_factory.mktemp("prompts")
    rs = np.random.RandomState(0)
    for name in ("utt", "dlg_1", "dlg_2"):
        wav = (rs.randn(8000) * 0.05).astype(np.float32)
        save_wav(str(d / f"{name}.wav"), wav, 8000)
        np.save(str(d / f"{name}.hubert_code.npy"), rs.randint(0, 500, 49).astype(str))
        with jax.default_matmul_precision("highest"):
            np.save(str(d / f"{name}.mel.npy"), np.asarray(mel_spectrogram(jnp.asarray(wav[None]), MelConfig()))[0])
    return str(d)


def _run_both(js, ps, call):
    """call(synth, key_or_generator) on both sides, with the JAX flow
    sampler's y0 recorded and handed to the port's flow_sample in order."""
    noises = []
    j_sample = js._sample_fn

    def recording_sample(params, *, key, phoneme_ids, cond, valid_len):
        noises.append(np.asarray(jax.random.normal(key, cond.shape[:2] + (js.acoustic_cfg.mel_dim,), jnp.float32)))
        return j_sample(params, key=key, phoneme_ids=phoneme_ids, cond=cond, valid_len=valid_len)

    j_tokens, p_tokens = [], []
    j_gen, p_gen = js._gen_fn, ps._gen_fn
    js._sample_fn = recording_sample
    js._gen_fn = lambda *a, **k: _record(j_tokens, j_gen(*a, **k))
    ps._gen_fn = lambda *a, **k: _record(p_tokens, p_gen(*a, **k))
    ps.flow_sample = lambda ph, cond, g: PSynth.flow_sample(ps, ph, cond, g, noise=torch.from_numpy(noises.pop(0).copy()))
    try:
        with jax.default_matmul_precision("highest"):
            jwav = np.asarray(call(js, jax.random.PRNGKey(11)))
        n_flow = len(noises)
        pwav = call(ps, torch.Generator().manual_seed(0))
    finally:
        js._sample_fn, js._gen_fn, ps._gen_fn = j_sample, j_gen, p_gen
        del ps.flow_sample
    assert n_flow > 0 and not noises          # the port drew exactly the JAX sampler's y0s
    return jwav, pwav, j_tokens, p_tokens


def _record(store, gen):
    store.append((np.asarray(gen.tokens), np.asarray(gen.tokens2)))
    return gen


CASES = [(mode, kind, fuse) for mode in MODELS for kind in ("monologue", "dialogue") for fuse in (False, True)]


@pytest.mark.parametrize("mode,kind,fuse_tail", CASES, ids=[f"{m}-{k}-{'fused' if f else 'exact'}" for m, k, f in CASES])
def test_synthesizer_matches_jax(synths, prompt_dir, mode, kind, fuse_tail):
    js, ps = synths[mode]
    js.fuse_tail = ps.fuse_tail = fuse_tail
    if kind == "monologue":
        prompt = os.path.join(prompt_dir, "utt.hubert_code.npy")
        call = lambda s, rng: s.monologue(mode, "Hello, world!", prompt, rng)
    else:
        p1, p2 = (os.path.join(prompt_dir, f"dlg_{i}.hubert_code.npy") for i in (1, 2))
        call = lambda s, rng: s.dialogue(mode, "Hi there. [spkchange] hello back", p1, p2, rng)
    jwav, pwav, jt, pt = _run_both(js, ps, call)
    assert len(jt) == len(pt) > 0
    for (a1, a2), (b1, b2) in zip(jt, pt):
        np.testing.assert_array_equal(b1, a1)
        np.testing.assert_array_equal(b2, a2)
    assert pwav.dtype == np.float32 and pwav.shape == jwav.shape and len(pwav) > 0
    assert np.abs(pwav - jwav).max() < WAV_TOL


def test_prepare_prompt_matches_jax(synths, tmp_path):
    """Codes cast from strings, mel from the wav (no cache), capped at 400
    frames; the mel within the frontends' 1e-3 (log domain, f32 DFT sums in
    two orders)."""
    js, ps = synths["covosingle"]
    wav = np.clip(np.random.RandomState(4).randn(8000 * 9) * 0.1, -1, 1).astype(np.float32)   # 9 s > 8 s cap
    save_wav(str(tmp_path / "p.wav"), wav, 8000)
    np.save(str(tmp_path / "p.hubert_code.npy"), np.arange(500).astype(str))
    with jax.default_matmul_precision("highest"):
        jsem, jmel = js.prepare_prompt(str(tmp_path / "p.hubert_code.npy"))
    psem, pmel = ps.prepare_prompt(str(tmp_path / "p.hubert_code.npy"))
    np.testing.assert_array_equal(psem, jsem)
    assert psem.dtype.kind == "i" and pmel.shape == jmel.shape == (400, 80)
    assert np.abs(pmel - jmel).max() < 1e-3
    assert np.abs(ps.extract_mel(str(tmp_path / "p.wav")) - js.extract_mel(str(tmp_path / "p.wav"))).max() < 1e-3


def test_encode_bucketed_matches_jax(synths):
    js, ps = synths["covomix"]
    for text in ("", "hi", "a much longer script with [spkchange] turns and [laughter] in it"):
        np.testing.assert_array_equal(ps._encode_bucketed(text), js._encode_bucketed(text))


@pytest.mark.parametrize("mode,models,match", [
    ("covosingle", "covosinx", "VoSingle"), ("covosinx", "covosingle", "two-stream"),
    ("covomix", "covosinx", "CoMix"), ("covomix", "covosingle", "two-stream")])
def test_check_mode_errors_match_jax(synths, mode, models, match):
    js, ps = synths[models]
    with pytest.raises(ValueError, match=match) as jerr:
        js._check_mode(mode)
    with pytest.raises(ValueError, match=match) as perr:
        ps._check_mode(mode)
    assert str(perr.value) == str(jerr.value)


def test_default_device_and_speculative(synths):
    """No device means cuda: without a card the constructor raises. With
    `speculative=True`, a T2S without the early-exit head, and a CoMix one
    whose head lacks the stream-2 draft head (as the released checkpoints
    do), raise the JAX Synthesizer's ValueErrors."""
    js, ps = synths["covomix"]
    args = (ps.t2s_params, ps.t2s_cfg, ps.acoustic_params, ps.acoustic_cfg, ps.vocoder_params, ps.vocoder_cfg,
            ps.tokenizer)
    jargs = (js.t2s_params, js.t2s_cfg, js.acoustic_params, js.acoustic_cfg, js.vocoder_params, js.vocoder_cfg,
             js.tokenizer)
    with pytest.raises(ValueError, match="early-exit head") as jerr:
        JSynth(*jargs, speculative=True)
    with pytest.raises(ValueError, match="early-exit head") as perr:
        PSynth(*args, speculative=True, device="cpu")
    assert str(perr.value) == str(jerr.value)
    stream1_head = {"early_exit": {"to_logits": {"w": np.zeros((32, 502), np.float32)}}}
    with pytest.raises(ValueError, match="stream-2 draft head") as jerr:
        JSynth({**_numpy_params(0)["comix"], **stream1_head}, dataclasses.replace(js.t2s_cfg, target_early_exit_layer=1),
               *jargs[2:], speculative=True)
    with pytest.raises(ValueError, match="stream-2 draft head") as perr:
        PSynth({**_numpy_params(0)["comix"], **stream1_head}, dataclasses.replace(ps.t2s_cfg, target_early_exit_layer=1),
               *args[2:], speculative=True, device="cpu")
    assert str(perr.value) == str(jerr.value)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        PSynth(*args)
