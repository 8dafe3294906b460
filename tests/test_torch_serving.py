"""The whole slice: the port's BatchedPipeline against the JAX package's
BatchedPipeline(fused=True, mesh=None) on the same weights and inputs.

Both decode greedily (the JAX pipeline's T2S stage is swapped for a k = 1
partial of its own `generate` before its first call), and the port is handed
the JAX flow sampler's y0, so the two runs see the same numbers. Mixed prompt
lengths, short rows included, exercise the per-row left-packing shifts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import text2semantic as JT
from covomix_tpu.serving import BatchedPipeline as JaxPipeline
from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.serving import BatchedPipeline, pack_rows, slice_generated

from _torch_port import GREEDY_THRES, J_AC, J_T2S, J_VOC, P_AC, P_T2S, P_VOC, jax_params

B, PMAX, L = 3, 8, 24
PROMPT_LENS = np.array([8, 3, 6], np.int32)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(1, 200, (B, 6)).astype(np.int32),
            rs.randint(0, 500, (B, PMAX, 2)).astype(np.int32),
            (rs.randn(B, PMAX, 160) * 0.1).astype(np.float32))


@pytest.mark.parametrize("min_length", [0, L])
def test_batched_pipeline_matches_jax(min_length):
    jt, ja, jv = jax_params(1)
    text, ptok, pmel = _inputs(2)
    key = jax.random.PRNGKey(7)
    jpipe = JaxPipeline(jt, J_T2S, ja, J_AC, jv, J_VOC, mesh=None, decode_len=L, dtype=jnp.float32,
                        fused=True, min_length=min_length)
    jpipe._gen = functools.partial(JT.generate, cfg=J_T2S, max_length=L, min_length=min_length,
                                   dtype=jnp.float32, top_k_thres=GREEDY_THRES)
    with jax.default_matmul_precision("highest"):
        jwav, jgen = jpipe(key, text, ptok, pmel, prompt_lens=PROMPT_LENS)
        y0 = np.array(jax.random.normal(jax.random.split(key)[1], (B, PMAX + L, 80)))
    numpy_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    ppipe = BatchedPipeline(numpy_tree(jt), P_T2S, numpy_tree(ja), P_AC, numpy_tree(jv), P_VOC,
                            decode_len=L, dtype=torch.float32, min_length=min_length,
                            top_k_thres=GREEDY_THRES, device="cpu")
    pwav, pgen = ppipe(torch.Generator().manual_seed(0), text, ptok, pmel, prompt_lens=PROMPT_LENS,
                       noise=torch.from_numpy(y0))
    np.testing.assert_array_equal(pgen.tokens.numpy(), np.asarray(jgen.tokens))
    np.testing.assert_array_equal(pgen.tokens2.numpy(), np.asarray(jgen.tokens2))
    np.testing.assert_array_equal(pgen.lengths.numpy(), np.asarray(jgen.lengths))
    assert pgen.num_steps == int(jgen.num_steps)
    jwav = np.asarray(jwav)
    assert pwav.shape == jwav.shape
    # f32 both sides: the flow's 32 evaluations and the vocoder's conv stack
    # carry summation-order differences of ~1e-6 into a ~0.05-scale wav
    assert np.abs(pwav.numpy() - jwav).max() < 1e-4


def test_placed_tensors_without_prompt_lens():
    """Device tensors with prompt_lens=None take the full prompt length, as
    numpy inputs do (they are not sent through place() again)."""
    jt, ja, jv = (jax.tree_util.tree_map(np.asarray, p) for p in jax_params(1))
    pipe = BatchedPipeline(jt, P_T2S, ja, P_AC, jv, P_VOC, decode_len=L, dtype=torch.float32,
                           top_k_thres=GREEDY_THRES, device="cpu")
    text, ptok, pmel = _inputs(5)
    noise = torch.from_numpy(np.random.RandomState(6).randn(B, PMAX + L, 80).astype(np.float32))
    ref, _ = pipe(torch.Generator().manual_seed(0), text, ptok, pmel, noise=noise)
    placed = tuple(torch.as_tensor(a) for a in (text, ptok, pmel))
    out, _ = pipe(torch.Generator().manual_seed(0), *placed, noise=noise)
    assert torch.equal(out, ref)


def test_pack_rows_against_direct_packing():
    """Distinct tokens and wildly mixed prompt/decode lengths: the positional
    shift must place row i's tokens at [p_i, p_i + g_i) and fill the rest."""
    rs = np.random.RandomState(3)
    tok1 = rs.randint(0, 600, (B, L)).astype(np.int32)   # > 501 values test the clamp
    tok2 = rs.randint(0, 600, (B, L)).astype(np.int32)
    gen_lens = np.array([24, 0, 13], np.int32)
    _, ptok, pmel = _inputs(4)
    ph, cond = pack_rows(*(torch.from_numpy(a) for a in (tok1, tok2, gen_lens, ptok, pmel, PROMPT_LENS)),
                         two=True)
    exp_ph = np.full((B, PMAX + L, 2), 157, np.int32)
    exp_cond = np.zeros((B, PMAX + L, 160), np.float32)
    for i in range(B):
        p, g = PROMPT_LENS[i], gen_lens[i]
        exp_ph[i, :p] = ptok[i, :p]
        exp_ph[i, p:p + g] = np.stack([np.clip(tok1[i, :g], 0, 501), np.clip(tok2[i, :g], 0, 501)], -1)
        exp_cond[i, :p] = pmel[i, :p]
    np.testing.assert_array_equal(ph.numpy(), exp_ph)
    np.testing.assert_array_equal(cond.numpy(), exp_cond)
    ph1, _ = pack_rows(*(torch.from_numpy(a) for a in (tok1, tok2, gen_lens, ptok[..., 0], pmel, PROMPT_LENS)),
                       two=False)
    np.testing.assert_array_equal(ph1.numpy(), exp_ph[..., 0])


def test_slice_generated():
    mel = torch.arange(B * (PMAX + L) * 2, dtype=torch.float32).reshape(B, PMAX + L, 2)
    out = slice_generated(mel, torch.from_numpy(PROMPT_LENS), L)
    for i, p in enumerate(PROMPT_LENS):
        assert torch.equal(out[i], mel[i, p:p + L])


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedPipeline({}, P_T2S, {}, P_AC, {}, P_VOC)   # the default device is cuda


def test_two_stream_prompt_tensor_of_two_dims_is_stacked():
    """A 2-D prompt_tokens tensor [B, P] for the two-stream model serves both
    streams, as the same numpy array does through place()."""
    jt, ja, jv = (jax.tree_util.tree_map(np.asarray, p) for p in jax_params(1))
    pipe = BatchedPipeline(jt, P_T2S, ja, P_AC, jv, P_VOC, decode_len=L, dtype=torch.float32,
                           top_k_thres=GREEDY_THRES, device="cpu")
    rs = np.random.RandomState(8)
    text = rs.randint(1, 200, (2, 6)).astype(np.int32)
    ptok = rs.randint(0, 500, (2, 5)).astype(np.int32)
    pmel = (rs.randn(2, 5, 160) * 0.1).astype(np.float32)
    noise = torch.from_numpy(rs.randn(2, 5 + L, 80).astype(np.float32))
    ref, _ = pipe(torch.Generator().manual_seed(0), text, ptok, pmel, noise=noise)
    out, _ = pipe(torch.Generator().manual_seed(0), *(torch.as_tensor(a) for a in (text, ptok, pmel)), noise=noise)
    assert out.shape == ref.shape and torch.equal(out, ref)


def test_jax_only_fields_are_accepted_without_effect():
    """`fused` and `prompt_frames`, the JAX pipeline's fields, build and change
    nothing: the same tokens and wavs as without them."""
    jt, ja, jv = (jax.tree_util.tree_map(np.asarray, p) for p in jax_params(1))
    kw = dict(decode_len=L, dtype=torch.float32, top_k_thres=GREEDY_THRES, device="cpu")
    text, ptok, pmel = _inputs(9)
    noise = torch.from_numpy(np.random.RandomState(10).randn(B, PMAX + L, 80).astype(np.float32))
    runs = []
    for extra in ({}, {"fused": False, "prompt_frames": 400}):
        pipe = BatchedPipeline(jt, P_T2S, ja, P_AC, jv, P_VOC, **kw, **extra)
        runs.append(pipe(torch.Generator().manual_seed(0), text, ptok, pmel, prompt_lens=PROMPT_LENS, noise=noise))
    (ref, ref_gen), (out, gen) = runs
    assert torch.equal(gen.tokens, ref_gen.tokens) and torch.equal(gen.tokens2, ref_gen.tokens2)
    assert torch.equal(out, ref)
