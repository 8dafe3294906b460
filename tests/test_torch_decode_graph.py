"""The port's one-program T2S decode (`generate` and `generate_speculative`
as one step function over static buffers, run STEPS_PER_READ steps /
ROUNDS_PER_READ rounds between host reads) against the JAX package's
while_loops on the same weights, and against the eager loop it replaced
(`_eager_generate` below, the port's `generate` before the step function:
attention over the written cache slice, one host read per step).

Greedy decode (top_k_thres small enough that k = 1) makes the tokens
independent of the two frameworks' random numbers, so tokens, lengths and
the step count must equal JAX's exactly. With sampling, the port's draws
come from a torch.Generator: the tokens must equal the eager loop's for the
same seed, and the generator must end where the eager loop leaves it, for
every chunk length."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import text2semantic as JT
from covomix_tpu.ops import sampling as JS
from covomix_tpu_torch.models import layers as PL, text2semantic as PT
from covomix_tpu_torch.ops import sampling as PS

from _torch_port import GREEDY_THRES, J_T2S, port_cfg, to_port

L = 24
J_SINGLE = dataclasses.replace(J_T2S, two_output=False)
READS = ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "numpy")


@pytest.fixture(scope="module")
def models():
    """{name: (jax config, jax params, port config, port params)} for the
    CoMix two-stream config and its single-stream form."""
    out = {}
    for name, cfg, seed in (("comix", J_T2S, 0), ("single", J_SINGLE, 5)):
        jp = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
        out[name] = (cfg, jp, port_cfg(PT.T2SConfig, cfg), to_port(jp))
    return out


def _text(seed, b=3, s=7):
    ids = np.random.RandomState(seed).randint(1, 200, (b, s)).astype(np.int32)
    ids[1, 5:] = 0   # a right-padded row
    return ids


def _eos_favoured(jp):
    """The weights with EOS the largest logit by far (test_torch_t2s's
    early-stop fixture): with min_length m every row emits EOS at step m."""
    w = np.asarray(jp["sem_emb"]["w"]).copy()
    w[J_T2S.semantic_eos_id] = 50.0 * np.sign(np.asarray(jp["start_speech"])[:w.shape[1]] + 1e-6)
    return dict(jp, sem_emb={"w": jnp.asarray(w)})


def _assert_same(out, ref):
    for field in ("tokens", "tokens2", "lengths", "lengths2"):
        np.testing.assert_array_equal(np.asarray(getattr(out, field)), np.asarray(getattr(ref, field)), field)
    assert int(out.num_steps) == int(ref.num_steps)


@torch.no_grad()
def _eager_generate(params, cfg, generator, source_ids, *, max_length, temperature=1.0, top_k_thres=0.1,
                    cond_scale=1.0, min_length=0, no_repeat_ngram_size=0, dtype=torch.float32):
    """The port's eager decode loop before the step function (yardstick):
    a Python step index, attention over the cache slice written so far, a
    host read of the stop flag after every step."""
    b, dev = source_ids.shape[0], source_ids.device
    heads, dh = cfg.heads, cfg.dim_head
    eos, pad = cfg.semantic_eos_id, cfg.semantic_pad_id
    source_ids = PS.set_eos_id(source_ids, cfg.text_eos_id, cfg.text_pad_id)
    source_mask = source_ids != cfg.text_pad_id
    context = PT.encode_source(params, cfg, PT.embed_source(params, cfg, source_ids, dtype), source_mask, dtype)
    use_cfg = cond_scale > 1.0
    if use_cfg:
        context = torch.cat([context, context], dim=0)
        source_mask = torch.cat([source_mask, torch.zeros_like(source_mask)], dim=0)
    bb = context.shape[0]
    cross_kvs = [PT._context_kv(lp["cross_attn"], context, heads) for lp in params["target_layers"]]
    inv = PL.rotary_freqs(dh, device=dev)
    cache_k = [torch.zeros((bb, heads, max_length, dh), dtype=dtype) for _ in params["target_layers"]]
    cache_v = [torch.zeros((bb, heads, max_length, dh), dtype=dtype) for _ in params["target_layers"]]
    tokens1 = torch.full((b, max_length), pad, dtype=torch.int32)
    tokens2 = torch.full((b, max_length), pad, dtype=torch.int32)
    done1 = done2 = torch.zeros(b, dtype=torch.bool)
    start = params["start_speech"].to(dtype)[None, :].expand(b, -1)
    eos_col = torch.arange(cfg.num_semantic_tokens + 1) == eos

    def decode_step(i, prev1, prev2):
        x = start if i == 0 else PT._embed_target(params, cfg, prev1, prev2, dtype)
        if use_cfg:
            x = torch.cat([x, x], dim=0)
        x = x[:, None, :]
        pos = torch.full((1,), i)
        for li, lp in enumerate(params["target_layers"]):
            sa = lp["self_attn"]
            h = PL.rmsnorm(sa["norm"], x)
            q = PL.split_heads(PL.linear(sa["q"], h), heads)
            k_new, v_new = torch.chunk(PL.linear(sa["kv"], h), 2, dim=-1)
            k_new, v_new = PL.split_heads(k_new, heads), PL.split_heads(v_new, heads)
            q = PL.rotary_interleaved(pos, inv, q)
            cache_k[li][:, :, i] = PL.rotary_interleaved(pos, inv, k_new)[:, :, 0]
            cache_v[li][:, :, i] = v_new[:, :, 0]
            att = PL.attend(q, cache_k[li][:, :, : i + 1], cache_v[li][:, :, : i + 1])
            x = PL.linear(sa["out"], PL.merge_heads(att)) + x
            x = PT._cross_attn(lp["cross_attn"], x, cross_kvs[li], heads, context_mask=source_mask) + x
            x = PT._ff(lp["ff"], x) + x
        return PL.rmsnorm(params["target_final_norm"], x)[:, 0]

    def head_logits(h):
        if cfg.two_output:
            half = cfg.target_dim // 2
            return PT._sem_logits(params, h[..., :half], dtype), PT._sem_logits(params, h[..., half:], dtype)
        lg = PT._sem_logits(params, h, dtype)
        return lg, lg

    i, stopped = 0, False
    while i < max_length:
        lg1, lg2 = head_logits(decode_step(i, tokens1[:, max(i - 1, 0)], tokens2[:, max(i - 1, 0)]))
        if use_cfg:
            lg1 = lg1[b:] + (lg1[:b] - lg1[b:]) * cond_scale
            lg2 = lg2[b:] + (lg2[:b] - lg2[b:]) * cond_scale
        if i < min_length:
            lg1 = lg1.masked_fill(eos_col[None, :], PS.NEG_INF)
            lg2 = lg2.masked_fill(eos_col[None, :], PS.NEG_INF)
        if no_repeat_ngram_size > 0:
            lg1 = PS.ban_repeated_ngrams(lg1, tokens1, i, no_repeat_ngram_size)
            if cfg.two_output:
                lg2 = PS.ban_repeated_ngrams(lg2, tokens2, i, no_repeat_ngram_size)
        s1 = PS.gumbel_sample(generator, PS.top_k_filter(lg1, thres=top_k_thres), temperature).to(torch.int32)
        tokens1[:, i] = s1
        done1 = done1 | (s1 == eos)
        if cfg.two_output:
            s2 = PS.gumbel_sample(generator, PS.top_k_filter(lg2, thres=top_k_thres), temperature).to(torch.int32)
            tokens2[:, i] = s2
            done2 = done2 | (s2 == eos)
        else:
            tokens2, done2 = tokens1, done1
        i += 1
        stopped = bool(done1.all()) or (cfg.two_output and bool(done2.all()))
        if stopped:
            break
    if stopped:
        tokens1 = PS.mask_after_eos(tokens1, eos, pad)
        tokens2 = PS.mask_after_eos(tokens2, eos, pad)
    return PT.GenerateResult(tokens1, tokens2, torch.sum(tokens1 != pad, dim=-1), torch.sum(tokens2 != pad, dim=-1),
                             i)


@pytest.mark.parametrize("name,cond_scale,min_length,ngram", [
    ("comix", 1.0, 0, 0), ("comix", 2.0, 5, 0), ("comix", 1.0, L, 2), ("comix", 2.0, L, 0),
    ("single", 1.0, 0, 2), ("single", 2.0, 0, 0), ("single", 1.0, 5, 0), ("single", 2.0, L, 2)])
def test_generate_matches_jax(models, name, cond_scale, min_length, ngram):
    """Greedy `generate` == the JAX while_loop: tokens, tokens2, lengths,
    num_steps, single-stream and CoMix, with and without T2S CFG, min_length
    0 / 5 / max_length, no_repeat_ngram_size 2."""
    jcfg, jp, pcfg, pp = models[name]
    ids = _text(2)
    kw = dict(max_length=L, top_k_thres=GREEDY_THRES, cond_scale=cond_scale, min_length=min_length,
              no_repeat_ngram_size=ngram)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(JT.generate, cfg=jcfg, **kw))(jp, key=jax.random.PRNGKey(0),
                                                                      source_ids=jnp.asarray(ids))
    out = PT.generate(pp, pcfg, torch.Generator().manual_seed(0), torch.from_numpy(ids), **kw)
    _assert_same(out, ref)
    if min_length == L:
        assert out.num_steps == L


def test_generate_stops_early_like_jax(models):
    """EOS favoured and masked for 5 steps: every row emits EOS at step 5,
    the decode stops after 6 steps, as the JAX loop does, mid-chunk."""
    jcfg, jp, pcfg, _ = models["comix"]
    jp = _eos_favoured(jp)
    ids = _text(3)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(JT.generate, cfg=jcfg, max_length=L, top_k_thres=GREEDY_THRES,
                                        min_length=5))(jp, key=jax.random.PRNGKey(0), source_ids=jnp.asarray(ids))
    out = PT.generate(to_port(jp), pcfg, torch.Generator().manual_seed(0), torch.from_numpy(ids), max_length=L,
                      top_k_thres=GREEDY_THRES, min_length=5)
    _assert_same(out, ref)
    assert out.num_steps == 6 and out.num_steps % PT.STEPS_PER_READ


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", ["stop_at_6", "full_length", "cfg_ngram"])
def test_chunk_length_keeps_tokens_and_generator(models, monkeypatch, k, case):
    """Sampling (top-k 0.1, temperature 1) from a seeded generator, with
    STEPS_PER_READ = k: the tokens and num_steps equal the eager loop's for
    the same seed, the caller's generator's next draw equals the one after
    the eager loop (the no-op steps of a chunk that ran past the stop give
    their draws back), and the call reads the device at most
    ceil(num_steps / k) + 1 times."""
    _, jp, pcfg, pp = models["comix"]
    kw = {"max_length": L}
    if case == "stop_at_6":
        pp, kw = to_port(_eos_favoured(jp)), dict(kw, min_length=5)
    elif case == "full_length":
        kw = dict(kw, min_length=L)
    else:
        kw = dict(kw, cond_scale=2.0, no_repeat_ngram_size=2, min_length=L)
    ids = torch.from_numpy(_text(4))
    g_ref = torch.Generator().manual_seed(11)
    ref = _eager_generate(pp, pcfg, g_ref, ids, **kw)

    monkeypatch.setattr(PT, "STEPS_PER_READ", k)
    reads = []
    for name in READS:
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _o=orig, _n=name, **kw_: (reads.append(_n),
                                                                                           _o(self, *a, **kw_))[1])
    g = torch.Generator().manual_seed(11)
    out = PT.generate(pp, pcfg, g, ids, **kw)
    monkeypatch.undo()
    _assert_same(out, ref)
    assert out.num_steps == (6 if case == "stop_at_6" else L)
    assert len(reads) <= -(-out.num_steps // k) + 1 and set(reads) == {"tolist"}
    assert torch.equal(torch.rand(5, generator=g), torch.rand(5, generator=g_ref))


def test_max_length_edge_writes_in_bounds(models, monkeypatch):
    """A decode that never stops, with max_length 13 and 8 steps a read:
    the second chunk runs 3 steps past the end. They must be no-ops that
    write nothing past max_length - 1: every cache and token write lands at
    an index below 13, the step counter stops at 13, and the tokens and the
    generator equal the eager loop's."""
    _, _, pcfg, pp = models["comix"]
    ids = torch.from_numpy(_text(6))
    g_ref = torch.Generator().manual_seed(3)
    ref = _eager_generate(pp, pcfg, g_ref, ids, max_length=13, min_length=13)
    monkeypatch.setattr(PT, "STEPS_PER_READ", 8)
    written, built = [], []
    orig_copy, orig_build = torch.Tensor.index_copy_, PT._build_generate

    def index_copy_(self, dim, index, source):
        written.append((self.shape[dim], int(index.max()) if index.numel() else -1))
        return orig_copy(self, dim, index, source)

    def build(*args, **kwargs):
        built.append(orig_build(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(torch.Tensor, "index_copy_", index_copy_)
    monkeypatch.setattr(PT, "_build_generate", build)
    g = torch.Generator().manual_seed(3)
    out = PT.generate(pp, pcfg, g, ids, max_length=13, min_length=13)
    monkeypatch.undo()
    _assert_same(out, ref)
    assert out.num_steps == 13 and (out.tokens >= 0).all() and (out.tokens2 >= 0).all()
    per_step = 2 * pcfg.target_depth + 2           # K and V per layer, two token streams
    assert len(written) == 16 * per_step and all(size == 13 and at <= 12 for size, at in written)
    assert int(built[0].state["step"].tolist()) == 13
    assert torch.equal(torch.rand(5, generator=g), torch.rand(5, generator=g_ref))


@pytest.mark.parametrize("n,cur_len", [(2, 6), (3, 8), (3, 2), (1, 4), (2, 0)])
def test_ban_repeated_ngrams_device_cur_len(n, cur_len, monkeypatch):
    """The ban with a 0-dim tensor cur_len (as the captured step gives it)
    equals JAX's and reads nothing back from the device."""
    toks = np.array([[1, 2, 1, 2, 1, 3, 1, 2, -1, -1], [4, 4, 4, 4, 5, 4, 4, 4, -1, -1]], np.int32)
    logits = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    ref = JS.ban_repeated_ngrams(jnp.asarray(logits), jnp.asarray(toks), jnp.int32(cur_len), n)
    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, **k: pytest.fail("host read"))
    out = PS.ban_repeated_ngrams(torch.from_numpy(logits), torch.from_numpy(toks), torch.tensor(cur_len), n)
    monkeypatch.undo()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# generate_speculative


def _softened(cfg, seed):
    """Init with the logits softened so that greedy decode visits several
    tokens (test_torch_speculative's fixtures)."""
    p = dict(jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    p["sem_emb"] = {"w": p["sem_emb"]["w"] * 0.3}
    return p


SPEC = JT.T2SConfig(dim=48, source_depth=1, target_depth=2, heads=2, dim_head=16, num_text_tokens=40,
                    num_semantic_tokens=12, target_dim=64, two_output=True, target_early_exit_layer=1)


@pytest.mark.parametrize("two_output,gamma", [(True, 2), (True, 3), (True, 4), (False, 2), (False, 4)])
def test_speculative_matches_jax_and_greedy(two_output, gamma):
    """generate_speculative == JAX generate_speculative == JAX greedy
    generate, both streams, and num_steps == JAX's verify rounds."""
    cfg = dataclasses.replace(SPEC, two_output=two_output, target_dim=64 if two_output else 48)
    params = _softened(cfg, 3 if two_output else 0)
    src = jax.random.randint(jax.random.PRNGKey(4), (3, 5), 1, 40)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(JT.generate_speculative, cfg=cfg, max_length=14,
                                        gamma=gamma))(params, source_ids=src)
        greedy = jax.jit(functools.partial(JT.generate, cfg=cfg, max_length=14, temperature=1e-10,
                                           top_k_thres=1.0))(params, key=jax.random.PRNGKey(9), source_ids=src)
    out = PT.generate_speculative(to_port(params), port_cfg(PT.T2SConfig, cfg), torch.from_numpy(np.array(src)),
                                  max_length=14, gamma=gamma)
    _assert_same(out, ref)
    for field in ("tokens", "tokens2", "lengths", "lengths2"):
        np.testing.assert_array_equal(getattr(out, field).numpy(), np.asarray(getattr(greedy, field)))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_speculative_chunk_length_keeps_result(monkeypatch, k):
    """ROUNDS_PER_READ = k: the same tokens and rounds as JAX, at most
    ceil(rounds / k) + 1 host reads."""
    params = _softened(SPEC, 3)
    src = jax.random.randint(jax.random.PRNGKey(4), (3, 5), 1, 40)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(JT.generate_speculative, cfg=SPEC, max_length=14,
                                        gamma=3))(params, source_ids=src)
    monkeypatch.setattr(PT, "ROUNDS_PER_READ", k)
    reads = []
    for name in READS:
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _o=orig, _n=name, **kw: (reads.append(_n),
                                                                                          _o(self, *a, **kw))[1])
    out = PT.generate_speculative(to_port(params), port_cfg(PT.T2SConfig, SPEC), torch.from_numpy(np.array(src)),
                                  max_length=14, gamma=3)
    monkeypatch.undo()
    _assert_same(out, ref)
    assert out.num_steps > 1 and len(reads) <= -(-out.num_steps // k) + 1


def test_weights_cast_once_per_call(models, monkeypatch):
    """In bf16 the decoder's weights are cast once per call, not per step:
    `layers.linear` meets only weights already in the activations' dtype
    (it still casts anything else, as before)."""
    _, _, pcfg, pp = models["comix"]
    casts = []
    orig = PL.linear

    def linear(p, x):
        casts.append(p["w"].dtype != x.dtype)
        return orig(p, x)

    monkeypatch.setattr(PL, "linear", linear)
    out = PT.generate(pp, pcfg, torch.Generator().manual_seed(0), torch.from_numpy(_text(2)), max_length=8,
                      min_length=8, dtype=torch.bfloat16)
    monkeypatch.undo()
    per_step = 7 * pcfg.target_depth                # q, kv, out; cross q, out; ff w1, w2
    once = 5 * pcfg.source_depth + pcfg.target_depth  # the encoder (q, kv, out, w1, w2) and the cross K/V
    assert out.num_steps == 8 and len(casts) == once + 8 * per_step and sum(casts) == once
