"""The port's T2S (CoMix, two-stream) decode against the JAX package on the
same weights. Greedy decode (top_k_thres small enough that k = 1) makes the
sampled tokens independent of the two frameworks' random numbers, so tokens,
lengths and the step count must be equal exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import text2semantic as JT
from covomix_tpu_torch.models import text2semantic as PT

from _torch_port import GREEDY_THRES, J_T2S, P_T2S, jax_params, to_port, tree_shapes

L = 24


@pytest.fixture(scope="module")
def params():
    jp = jax_params(0)[0]
    return jp, to_port(jp)


def _text(seed, b=3, s=7):
    ids = np.random.RandomState(seed).randint(1, 200, (b, s)).astype(np.int32)
    ids[1, 5:] = 0   # a right-padded row
    return ids


def test_init_names_and_shapes_match():
    jp = jax_params(0)[0]
    pp = PT.init(torch.Generator().manual_seed(0), P_T2S)
    assert tree_shapes(pp) == tree_shapes(jp)


def test_encode_source_matches_jax(params):
    jp, pp = params
    ids = _text(1)
    from covomix_tpu.ops import sampling as JS
    from covomix_tpu_torch.ops import sampling as PS

    with jax.default_matmul_precision("highest"):
        src = JS.set_eos_id(jnp.asarray(ids), J_T2S.text_eos_id, J_T2S.text_pad_id)
        ref = JT.encode_source(jp, J_T2S, JT.embed_source(jp, J_T2S, src), src != 0)
    psrc = PS.set_eos_id(torch.from_numpy(ids), P_T2S.text_eos_id, P_T2S.text_pad_id)
    out = PT.encode_source(pp, P_T2S, PT.embed_source(pp, P_T2S, psrc), psrc != 0)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 2e-5


def _generate_both(params, ids, **kw):
    jp, pp = params
    with jax.default_matmul_precision("highest"):
        fn = jax.jit(functools.partial(JT.generate, cfg=J_T2S, max_length=L, top_k_thres=GREEDY_THRES, **kw))
        ref = fn(jp, key=jax.random.PRNGKey(0), source_ids=jnp.asarray(ids))
    out = PT.generate(pp, P_T2S, torch.Generator().manual_seed(0), torch.from_numpy(ids), max_length=L,
                      top_k_thres=GREEDY_THRES, **kw)
    return ref, out


@pytest.mark.parametrize("kw", [{}, {"min_length": L}, {"min_length": 5, "no_repeat_ngram_size": 2}])
def test_greedy_generate_matches_jax(params, kw):
    ref, out = _generate_both(params, _text(2), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.tokens2.numpy(), np.asarray(ref.tokens2))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.lengths2.numpy(), np.asarray(ref.lengths2))
    assert out.num_steps == int(ref.num_steps)
    if kw.get("min_length") == L:
        assert out.num_steps == L


def test_early_stop_masks_after_eos():
    """Force an early EOS (all rows, stream 1) by making EOS the largest logit:
    the loop stops at once, and tokens past EOS are pad in both packages."""
    jp = jax_params(0)[0]
    w = np.asarray(jp["sem_emb"]["w"]).copy()
    w[J_T2S.semantic_eos_id] = 50.0 * np.sign(np.asarray(jp["start_speech"])[:32] + 1e-6)
    jp = dict(jp, sem_emb={"w": jnp.asarray(w)})
    ref, out = _generate_both((jp, to_port(jp)), _text(3))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.tokens2.numpy(), np.asarray(ref.tokens2))
    assert out.num_steps == int(ref.num_steps) < L


def test_speculative_not_ported(params):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PT.generate(params[1], P_T2S, None, torch.from_numpy(_text(4)), max_length=4, speculative=True)
