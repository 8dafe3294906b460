"""The port's HuBERT tokenizer (`covomix_tpu_torch/models/hubert.py`) and its
norms against the JAX package on the CPU, at tests/test_hubert.py's tiny
config, on the same weights (the JAX init carried across) and waveforms.
f32 with the JAX side at the highest matmul precision: features within
FEAT_TOL, unit ids equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import hubert as JH, layers as JL
from covomix_tpu_torch.models import hubert as PH, layers as PL

from _torch_port import to_port

JCFG = JH.HubertConfig(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_layers=2, encoder_embed_dim=32,
                       encoder_ffn_dim=64, encoder_heads=4, conv_pos=16, conv_pos_groups=4, output_layer=2,
                       num_units=11)
PCFG = PH.HubertConfig(**dataclasses.asdict(JCFG))
FEAT_TOL = 1e-5       # f32 both sides; only summation order differs


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(JH.init, static_argnums=1)(jax.random.PRNGKey(3), JCFG)
    return jp, to_port(jp)


def _wav(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32) * 0.1


def test_init_matches_jax_tree():
    from _torch_port import tree_shapes

    jp = jax.jit(JH.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    pp = PH.init(torch.Generator().manual_seed(0), PCFG)
    assert tree_shapes(pp) == tree_shapes(jp)
    assert PH.num_output_frames(PCFG, 1234) == JH.num_output_frames(JCFG, 1234)
    assert PH.HubertConfig().downsample == 320 and PH.num_output_frames(PH.HubertConfig(), 16000) == 49


@pytest.mark.parametrize("n", [800, 1333])
def test_extract_features_matches_jax(params, n):
    jp, pp = params
    wav = _wav(n, n)[None]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JH.extract_features(jp, JCFG, jnp.asarray(wav)))
    out = PH.extract_features(pp, PCFG, torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=FEAT_TOL, rtol=0)


def test_kmeans_assign_ids_equal(params):
    jp, pp = params
    feats = np.random.RandomState(1).randn(3, 7, JCFG.encoder_embed_dim).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JH.kmeans_assign(jp, jnp.asarray(feats)))
    np.testing.assert_array_equal(PH.kmeans_assign(pp, torch.from_numpy(feats)).numpy(), ref)


def test_padded_batch_equals_per_file(params):
    """Mixed lengths in one padded batch (padding_mask + valid_samples): each
    row's ids equal its exact-length extraction, in the port and in JAX."""
    jp, pp = params
    lens = [473, 301, 640]
    wavs = [_wav(n, 7 + i) for i, n in enumerate(lens)]
    batch = np.zeros((len(lens), max(lens)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    fv = [PH.num_output_frames(PCFG, n) for n in lens]
    mask = np.arange(PH.num_output_frames(PCFG, max(lens)))[None, :] < np.asarray(fv)[:, None]
    ids = PH.wav2units_batch(pp, PCFG, torch.from_numpy(batch), padding_mask=torch.from_numpy(mask),
                             valid_samples=torch.tensor(lens)).numpy()
    with jax.default_matmul_precision("highest"):
        jids = np.asarray(JH.wav2units_jit(jp, JCFG, jnp.asarray(batch), padding_mask=jnp.asarray(mask),
                                           valid_samples=jnp.asarray(lens, jnp.int32)))
    for i, w in enumerate(wavs):
        exact = PH.wav2units_batch(pp, PCFG, torch.from_numpy(w[None]))[0].numpy()
        np.testing.assert_array_equal(ids[i, : fv[i]], exact, err_msg=f"row {i}")
        np.testing.assert_array_equal(ids[i, : fv[i]], jids[i, : fv[i]], err_msg=f"row {i} vs JAX")


@pytest.mark.parametrize("n", [1500, 1420, 16000 + 300])
def test_wav2units_chunking_matches_jax(params, n):
    """Chunks of max_chunk samples, the 1 s bucket with a padding mask, and
    a short tail: 1500 = 700 + 700 + 100 (a tail under the receptive field
    gives no frames), 1420 = 700 + 700 + 20, 16300 = chunks of 700 with a
    600-sample tail."""
    jp, pp = params
    jcfg = dataclasses.replace(JCFG, max_chunk=700)
    pcfg = dataclasses.replace(PCFG, max_chunk=700)
    wav = _wav(n, 2)
    with jax.default_matmul_precision("highest"):
        ref = JH.wav2units(jp, jcfg, wav)
    out = PH.wav2units(pp, pcfg, wav)
    assert out.dtype == np.int64 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_wav2units_unbucketed_and_empty(params):
    """A whole number of seconds runs without a mask; a wav shorter than the
    receptive field gives no ids."""
    jp, pp = params
    wav = _wav(16000, 4)
    with jax.default_matmul_precision("highest"):
        ref = JH.wav2units(jp, JCFG, wav)
    np.testing.assert_array_equal(PH.wav2units(pp, PCFG, wav), ref)
    assert PH.wav2units(pp, PCFG, _wav(9, 5)).shape == (0,)


@pytest.mark.parametrize("masked", [False, True])
def test_layernorm_and_groupnorm_length_mask(masked):
    rs = np.random.RandomState(3)
    x = (rs.randn(3, 20, 8) * 2 + 1).astype(np.float32)
    p = {"gamma": rs.randn(8).astype(np.float32), "beta": rs.randn(8).astype(np.float32)}
    pp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(PL.layernorm(pp, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.layernorm(p, jnp.asarray(x))), atol=1e-6, rtol=0)
    lm = (np.arange(20)[None, :] < np.array([20, 13, 1])[:, None]) if masked else None
    for groups in (8, 2):
        ref = np.asarray(JL.groupnorm(p, jnp.asarray(x), groups, length_mask=None if lm is None else jnp.asarray(lm)))
        out = PL.groupnorm(pp, torch.from_numpy(x), groups,
                           length_mask=None if lm is None else torch.from_numpy(lm)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_on_frontend_features(params, dtype):
    """The dtype rule (exact erf in f32, tanh in bf16) on the conv
    frontend's pre-activation features."""
    jp, _ = params
    wav = jnp.asarray(_wav(2000, 6)[None])
    x = np.array(JL.conv1d(jp["conv_layers"][0], wav[..., None], stride=5, padding="VALID"), np.float32)
    jt, pt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(JL.gelu(jnp.asarray(x).astype(jt)).astype(jnp.float32))
    out = PL.gelu(torch.from_numpy(x).to(pt)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -7    # one bf16 rounding of |gelu| < 2
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


def test_conv1d_stride_valid_and_grouped_pos_conv(params):
    """conv1d as HuBERT calls it: stride with VALID padding, and the
    positional conv (groups, padding k/2)."""
    jp, pp = params
    x = np.random.RandomState(8).randn(2, 40, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        r1 = np.asarray(JL.conv1d(jp["conv_layers"][1], jnp.asarray(x), stride=2, padding="VALID"))
        r2 = np.asarray(JL.conv1d(jp["pos_conv"], jnp.asarray(x), padding=8, groups=4))
    o1 = PL.conv1d(pp["conv_layers"][1], torch.from_numpy(x), stride=2, padding="VALID").numpy()
    o2 = PL.conv1d(pp["pos_conv"], torch.from_numpy(x), padding=8, groups=4).numpy()
    np.testing.assert_allclose(o1, r1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o2, r2, atol=1e-5, rtol=0)
