"""The port's self-speculative T2S decode (`generate_speculative`) against the
JAX package's and against greedy `generate`, on the same weights: the
fixtures of tests/test_speculative.py (single-stream and CoMix two_output,
gamma 1 and 3), a model fitted in the port on a decodable pattern whose two
streams end at different positions (acceptance, the global stop rebuilt
after the loop, one host read per round), the early-exit head's init and
checkpoint round trip, and speculation through BatchedPipeline, the
Synthesizer, `serve_batch --speculative` and `dialogue_generation
--speculative` on the CPU.

Greedy on both sides is `generate` at temperature 1e-10 with top_k_thres 1.0
(argmax), as the JAX tests run it; f32 at 'highest' precision on the JAX
side. Tokens must be equal, position for position."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from covomix_tpu.checkpoint import io as jio
from covomix_tpu.models import text2semantic as JT
from covomix_tpu_torch import dialogue_generation, serve_batch
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV
from covomix_tpu_torch.pipeline import Synthesizer as PSynth
from covomix_tpu_torch.serving import BatchedPipeline
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves

from _torch_port import J_AC, J_VOC, P_AC, P_VOC, port_cfg, to_port, tree_shapes

CFG = JT.T2SConfig(dim=48, source_depth=1, target_depth=2, heads=2, dim_head=16,
                   num_text_tokens=40, num_semantic_tokens=12, target_dim=48, target_early_exit_layer=1)
CFG2 = JT.T2SConfig(dim=48, source_depth=1, target_depth=2, heads=2, dim_head=16,
                    num_text_tokens=40, num_semantic_tokens=12, target_dim=64, two_output=True,
                    target_early_exit_layer=1)
# the fitted model's targets: stream 1 LEN1 tokens, stream 2 LEN2, then EOS
LEN1, LEN2 = 16, 14
FIT_STEPS = 250


def _softened(cfg, seed):
    """The JAX fixtures: init, with the logits softened so that greedy decode
    visits several tokens."""
    p = dict(jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    p["sem_emb"] = {"w": p["sem_emb"]["w"] * 0.3}
    return p


@pytest.fixture(scope="module")
def fixtures():
    return {"single": (CFG, _softened(CFG, 0)), "comix": (CFG2, _softened(CFG2, 3))}


def _greedy_jax(params, cfg, src, max_length):
    with jax.default_matmul_precision("highest"):
        return jax.jit(functools.partial(JT.generate, cfg=cfg, max_length=max_length, temperature=1e-10,
                                         top_k_thres=1.0))(params, key=jax.random.PRNGKey(99), source_ids=src)


def _spec_jax(params, cfg, src, max_length, gamma):
    with jax.default_matmul_precision("highest"):
        return jax.jit(functools.partial(JT.generate_speculative, cfg=cfg, max_length=max_length,
                                         gamma=gamma))(params, source_ids=src)


def _assert_same_tokens(port, ref):
    np.testing.assert_array_equal(port.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(port.tokens2.numpy(), np.asarray(ref.tokens2))
    np.testing.assert_array_equal(port.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(port.lengths2.numpy(), np.asarray(ref.lengths2))


@pytest.mark.parametrize("name,gamma", [("single", 1), ("single", 3), ("comix", 1), ("comix", 3)])
def test_generate_speculative_matches_jax_and_greedy(fixtures, name, gamma):
    """Port speculative == JAX speculative == JAX greedy, both streams, and
    the same number of verify rounds as JAX."""
    cfg, params = fixtures[name]
    b, max_length = (2, 12) if name == "single" else (3, 14)
    src = jax.random.randint(jax.random.PRNGKey(1 if name == "single" else 4), (b, 5), 1, 40)
    ref = _spec_jax(params, cfg, src, max_length, gamma)
    out = PT.generate_speculative(to_port(params), port_cfg(PT.T2SConfig, cfg),
                                  torch.from_numpy(np.array(src)), max_length=max_length, gamma=gamma)
    _assert_same_tokens(out, ref)
    _assert_same_tokens(out, _greedy_jax(params, cfg, src, max_length))
    assert out.num_steps == int(ref.num_steps)


def test_num_steps_bounds(fixtures):
    """Every round accepts at least one token and at most gamma+1: at most
    max_length rounds, at least max_length / (gamma+1)."""
    cfg, params = fixtures["single"]
    src = jax.random.randint(jax.random.PRNGKey(2), (1, 4), 1, 40)
    out = PT.generate_speculative(to_port(params), port_cfg(PT.T2SConfig, cfg), torch.from_numpy(np.array(src)),
                                  max_length=12, gamma=3)
    assert 3 <= out.num_steps <= 12
    assert out.num_steps == int(_spec_jax(params, cfg, src, 12, 3).num_steps)


@pytest.mark.parametrize("case", ["no_head", "no_stream2_head", "two_input"])
def test_missing_heads_raise_jax_errors(fixtures, case):
    """The JAX asserts, as AssertionErrors with the JAX messages: no draft
    head, a CoMix head without the stream-2 head, two text streams."""
    cfg, params = fixtures["single" if case == "no_head" else "comix"]
    if case == "no_head":
        params = {k: v for k, v in params.items() if k != "early_exit"}
    elif case == "no_stream2_head":
        params = dict(params, early_exit={k: v for k, v in params["early_exit"].items() if k != "to_logits2"})
    else:
        cfg = dataclasses.replace(cfg, two_input=True)
    with pytest.raises(AssertionError) as jerr:
        JT.generate_speculative(params, cfg, jnp.ones((1, 4), jnp.int32), max_length=8)
    with pytest.raises(AssertionError) as perr:
        PT.generate_speculative(to_port(params), port_cfg(PT.T2SConfig, cfg), torch.ones((1, 4), dtype=torch.int32),
                                max_length=8)
    assert str(perr.value) == str(jerr.value) != ""


def _pattern_batch(rs, b):
    """Random texts; targets the positional pattern (3 + j) % 12 on stream 1
    for LEN1 tokens, (5 + j) % 12 on stream 2 for LEN2, pad after."""
    text = rs.randint(1, 40, (b, 5)).astype(np.int32)
    j = np.arange(LEN1)
    tgt = np.stack([(3 + j) % 12, np.where(j < LEN2, (5 + j) % 12, -1)], axis=-1)
    return text, np.ascontiguousarray(np.broadcast_to(tgt, (b, LEN1, 2))).astype(np.int32)


@pytest.fixture(scope="module")
def fitted():
    """The CoMix config of CFG2 fitted in the port (Adam 3e-3, FIT_STEPS
    steps of 8 rows) on the decodable pattern, with both draft heads trained
    by forward_loss's early-exit CE. Returns (numpy tree, final loss)."""
    cfg = port_cfg(PT.T2SConfig, CFG2)
    params = PT.init(torch.Generator().manual_seed(0), cfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=3e-3)
    rs = np.random.RandomState(0)
    for _ in range(FIT_STEPS):
        text, tgt = _pattern_batch(rs, 8)
        loss = PT.forward_loss(params, cfg, torch.from_numpy(text), torch.from_numpy(tgt))
        opt.zero_grad()
        loss.backward()
        opt.step()
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), params), loss.item()


def test_acceptance_on_fitted_decodable_pattern(fitted):
    """On the fitted pattern the draft is accepted near the gamma+1 ceiling:
    rounds <= tokens / 2 (a positional, cache or head-pairing fault keeps
    the output exact but pins acceptance at one token a round). Stream 2
    ends first, so greedy stops at LEN2 + 1 and cuts stream 1 there, which
    the speculative decode rebuilds after its loop from the first-EOS
    positions; the tokens equal the port's greedy decode, and JAX's greedy
    and speculative decodes on the same weights."""
    tree, loss = fitted
    assert loss < 0.2, f"fit did not converge (loss {loss})"
    cfg = port_cfg(PT.T2SConfig, CFG2)
    params = pio.params_from_numpy(tree, "cpu")
    text, _ = _pattern_batch(np.random.RandomState(7), 3)
    greedy = PT.generate(params, cfg, torch.Generator().manual_seed(0), torch.from_numpy(text), max_length=24,
                         temperature=1e-10, top_k_thres=1.0)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    greedy_jax = _greedy_jax(jtree, CFG2, jnp.asarray(text), 24)
    for gamma in (1, 3):
        out = PT.generate_speculative(params, cfg, torch.from_numpy(text), max_length=24, gamma=gamma)
        _assert_same_tokens(out, greedy)
        _assert_same_tokens(out, greedy_jax)
        ref = _spec_jax(jtree, CFG2, jnp.asarray(text), 24, gamma)
        _assert_same_tokens(out, ref)
        assert out.num_steps == int(ref.num_steps)
    lens = torch.minimum(out.lengths, out.lengths2).float()
    assert greedy.num_steps == LEN2 + 1 and (lens == LEN2 + 1).all()
    assert (greedy.tokens2[:, LEN2] == cfg.semantic_eos_id).all() and (greedy.tokens[:, :LEN2 + 1] != -1).all()
    assert out.num_steps <= lens.mean().item() / 2, f"acceptance collapsed: {out.num_steps} rounds for {lens}"


def test_one_host_read_per_round(fitted, monkeypatch):
    """The loop reads the device once per chunk of ROUNDS_PER_READ rounds
    (the JAX cond_fn's any(active) with the round count, one `tolist`), the
    last read ending it; nothing else in the call converts a tensor to a
    Python value."""
    cfg = port_cfg(PT.T2SConfig, CFG2)
    params = pio.params_from_numpy(fitted[0], "cpu")
    text = torch.from_numpy(_pattern_batch(np.random.RandomState(8), 4)[0])
    reads = []

    def counting(name, orig):
        def read(self, *args, **kwargs):
            reads.append(name)
            return orig(self, *args, **kwargs)
        return read

    for name in ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, counting(name, getattr(torch.Tensor, name)))
    out = PT.generate_speculative(params, cfg, text, max_length=24, gamma=3)
    monkeypatch.undo()
    chunks = -(-out.num_steps // PT.ROUNDS_PER_READ)
    assert out.num_steps > 1 and reads == ["tolist"] * chunks


@pytest.mark.parametrize("two_output", [False, True], ids=["single", "comix"])
def test_early_exit_init_matches_jax(two_output):
    """The draft head's names and shapes: the feed-forward's inner width is
    int(target_dim * 4 * 2/3) whatever ff_mult, `to_logits2` for two_output."""
    jcfg = dataclasses.replace(CFG2, two_output=two_output, target_dim=64, ff_mult=2, target_early_exit_layer=2)
    jp = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    pp = PT.init(torch.Generator().manual_seed(0), port_cfg(PT.T2SConfig, jcfg))
    assert tree_shapes(pp) == tree_shapes(jp)
    assert tuple(pp["early_exit"]["ff"]["w2"]["w"].shape) == (int(64 * 4 * 2 / 3), 64) != \
        tuple(pp["target_layers"][0]["ff"]["w2"]["w"].shape)
    assert ("to_logits2" in pp["early_exit"]) == two_output


def test_save_load_params_with_early_exit(tmp_path):
    """A tree with the draft heads through the port's save_params into JAX's
    load_params and back through JAX's save_params into the port's
    load_params / params_from_numpy: same names, same values."""
    jcfg = dataclasses.replace(CFG2, target_early_exit_layer=2)
    pp = PT.init(torch.Generator().manual_seed(1), port_cfg(PT.T2SConfig, jcfg))
    pio.save_params(str(tmp_path / "port.npz"), pp, meta={"config": dataclasses.asdict(jcfg)})
    jtree = jio.load_params(str(tmp_path / "port.npz"))
    jio.save_params(str(tmp_path / "jax.npz"), jtree, meta={"config": dataclasses.asdict(jcfg)})
    back = pio.params_from_numpy(pio.load_params(str(tmp_path / "jax.npz")), "cpu")
    names = dict(named_leaves(back))
    assert {"early_exit/to_logits/w", "early_exit/to_logits2/w", "early_exit/ff/w1/w", "early_exit/norm/gamma"} \
        <= set(names)
    for name, leaf in named_leaves(pp):
        assert torch.equal(names[name], leaf), name
    assert pio.load_meta(str(tmp_path / "jax.npz"))["config"]["target_early_exit_layer"] == 2


def _tiny_models(seed=2):
    g = torch.Generator().manual_seed(seed)
    return PA.init(g, P_AC), PV.init_generator(g, P_VOC)


@pytest.mark.parametrize("gamma", [2, 4])
def test_batched_pipeline_speculative_equals_greedy(fitted, gamma):
    """BatchedPipeline(speculative=True): the T2S stage is the greedy decode
    of the same rows (the generator is not drawn from), so with the same
    flow noise the batch equals the pipeline with greedy `generate` in its
    place, wav and tokens."""
    ac, voc = _tiny_models()
    cfg = port_cfg(PT.T2SConfig, CFG2)
    rs = np.random.RandomState(3)
    b, decode, prompt = 3, 24, 10
    text = _pattern_batch(rs, b)[0]
    pt = rs.randint(0, 500, (b, prompt, 2)).astype(np.int32)
    pm = (rs.randn(b, prompt, 160) * 0.1).astype(np.float32)
    plens = np.array([10, 7, 9], np.int32)
    noise = torch.from_numpy(rs.randn(b, prompt + decode, 80).astype(np.float32))
    kw = dict(decode_len=decode, dtype=torch.float32, device="cpu")
    spec = BatchedPipeline(fitted[0], cfg, ac, P_AC, voc, P_VOC, speculative=True, spec_gamma=gamma, **kw)
    greedy = BatchedPipeline(fitted[0], cfg, ac, P_AC, voc, P_VOC, **kw)
    greedy._gen = lambda params, generator, source_ids: PT.generate(
        params, cfg, generator, source_ids, max_length=decode, temperature=1e-10, top_k_thres=1.0)
    wav_s, res_s = spec(None, text, pt, pm, prompt_lens=plens, noise=noise)
    wav_g, res_g = greedy(torch.Generator().manual_seed(0), text, pt, pm, prompt_lens=plens, noise=noise)
    _assert_same_tokens(res_s, res_g)
    assert res_s.num_steps < res_g.num_steps
    assert wav_s.shape == (b, PV.output_length(P_VOC, decode)) and torch.isfinite(wav_s).all()
    assert torch.equal(wav_s, wav_g)


def test_batched_pipeline_speculative_needs_the_head(fitted):
    """Without the draft head: the JAX AssertionError, before any work."""
    from covomix_tpu.serving import BatchedPipeline as JPipe

    ac, voc = _tiny_models()
    tree = {k: v for k, v in fitted[0].items() if k != "early_exit"}
    with pytest.raises(AssertionError) as jerr:
        JPipe(tree, CFG2, ac, J_AC, voc, J_VOC, speculative=True)
    with pytest.raises(AssertionError) as perr:
        BatchedPipeline(tree, port_cfg(PT.T2SConfig, CFG2), ac, P_AC, voc, P_VOC, speculative=True, device="cpu")
    assert str(perr.value) == str(jerr.value)
    assert [f.default for f in dataclasses.fields(BatchedPipeline) if f.name == "spec_gamma"] == [4]


class _Tok:
    def batch_encode(self, texts, max_length=512):
        ids = np.array([[5, 9, 3, 2]], np.int32)
        return ids, np.ones_like(ids, bool)


def test_synthesizer_speculative_wiring(fixtures):
    """Synthesizer(speculative=True) routes text_to_tokens through
    generate_speculative: the JAX greedy reference's tokens; a config
    without the early-exit layer raises JAX's ValueError."""
    cfg, params = fixtures["single"]
    ac_cfg = PA.AcousticConfig(dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16, num_phoneme_tokens=33)
    voc_cfg = PV.VocoderConfig(upsample_initial_channel=16)
    g = torch.Generator().manual_seed(1)
    kw = dict(t2s_params=to_port(params), t2s_cfg=port_cfg(PT.T2SConfig, cfg), acoustic_params=PA.init(g, ac_cfg),
              acoustic_cfg=ac_cfg, vocoder_params=PV.init_generator(g, voc_cfg), vocoder_cfg=voc_cfg,
              tokenizer=_Tok(), t2s_max_length=12, device="cpu")
    calls = []
    synth = PSynth(speculative=True, **kw)
    inner = synth._gen_fn
    synth._gen_fn = lambda *a, **k: calls.append(k) or inner(*a, **k)
    toks = synth.text_to_tokens("hello", torch.Generator().manual_seed(0))
    ref = np.asarray(_greedy_jax(params, cfg, jnp.asarray([[5, 9, 3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]]),
                                 12).tokens)[0]
    np.testing.assert_array_equal(toks, ref[ref != cfg.semantic_pad_id])
    assert len(calls) == 1
    with pytest.raises(ValueError, match="early-exit head"):
        PSynth(speculative=True, **{**kw, "t2s_cfg": port_cfg(PT.T2SConfig,
                                                               dataclasses.replace(cfg, target_early_exit_layer=0))})


def _cli_assets(root, t2s_tree):
    """`.npz` checkpoints (the fitted CoMix T2S with its draft heads, tiny
    VoMix and HiFi-GAN) and one two-speaker script with its prompts."""
    ac, voc = _tiny_models(4)
    for name, tree, cfg in (("t2s", t2s_tree, CFG2), ("ac", ac, J_AC), ("voc", voc, J_VOC)):
        pio.save_params(str(root / f"{name}.npz"), tree, meta={"config": json.loads(json.dumps(dataclasses.asdict(cfg)))})
    (root / "text").mkdir()
    (root / "prompt").mkdir()
    (root / "text" / "a.txt").write_text("hello world [spkchange] good morning")
    rs = np.random.RandomState(1)
    for spk in (1, 2):
        base = root / "prompt" / f"a_{spk}"
        np.save(f"{base}.hubert_code.npy", rs.randint(0, 500, 12).astype(str))
        np.save(f"{base}.mel.npy", rs.randn(80, 10 + spk).astype(np.float32))
    return ["--t2s_ckpt", str(root / "t2s.npz"), "--acous_ckpt", str(root / "ac.npz"),
            "--hifigan_ckpt", str(root / "voc.npz"), "--text_dir", str(root / "text"),
            "--prompt_dir", str(root / "prompt"), "--saved_dir", str(root / "out"), "--allow_fallback_vocab",
            "--device", "cpu", "--speculative"]


def _spy(monkeypatch):
    """Record every generate_speculative call (the gamma passed, or None for
    the default; the result); fail on a call of the sampling `generate`."""
    calls = []
    orig = PT.generate_speculative

    def spec(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append((kwargs.get("gamma"), res))
        return res

    def sampling(*args, **kwargs):
        raise AssertionError("the sampling decode ran")

    monkeypatch.setattr(PT, "generate_speculative", spec)
    monkeypatch.setattr(PT, "generate", sampling)
    return calls


def test_serve_batch_cli_speculative(fitted, tmp_path, monkeypatch):
    """`serve_batch --speculative --spec_gamma 2 --device cpu` on `.npz`
    checkpoints with the draft heads: the decode is generate_speculative at
    gamma 2, and the wav holds 160 samples per decoded frame."""
    calls = _spy(monkeypatch)
    argv = _cli_assets(tmp_path, fitted[0]) + ["--spec_gamma", "2", "--batch", "2", "--decode_len", "24",
                                               "--max_text_tokens", "16"]
    serve_batch.main(argv)
    assert len(calls) == 1 and calls[0][0] == 2
    res = calls[0][1]
    n = int(torch.minimum(res.lengths, res.lengths2)[0])
    sr, wav = wavfile.read(str(tmp_path / "out" / "a.wav"))
    assert sr == 8000 and n > 0 and len(wav) == n * 160


def test_dialogue_cli_speculative(fitted, tmp_path, monkeypatch):
    """`dialogue_generation --speculative --device cpu` (covomix): the script
    decodes through generate_speculative at its default gamma (JAX's, as the
    JAX Synthesizer calls it), and the wav is finite int16 of 160 samples
    per decoded frame."""
    calls = _spy(monkeypatch)
    dialogue_generation.main(_cli_assets(tmp_path, fitted[0]) + ["--mode", "covomix"])
    assert len(calls) == 1 and calls[0][0] is None
    res = calls[0][1]
    n = int(torch.minimum(res.lengths, res.lengths2)[0])
    sr, wav = wavfile.read(str(tmp_path / "out" / "a.wav"))
    assert sr == 8000 and wav.dtype == np.int16 and n > 0 and len(wav) == n * 160
