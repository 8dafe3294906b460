"""The port's HiFi-GAN generator against the JAX package on the same weights
and mel. f32, 'highest' precision; 1e-5 covers summation order over the
conv stack (the JAX package's packed MRF sums the same three branches)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import vocoder as JV
from covomix_tpu_torch.models import vocoder as PV

from _torch_port import J_VOC, P_VOC, jax_params, to_port, tree_shapes

TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jax_params(0)[2]
    return jp, to_port(jp)


def _mel(seed, b=3, t=24):
    return (np.random.RandomState(seed).randn(b, t, 80) * 0.5 - 4.0).astype(np.float32)


def test_init_names_and_shapes_match():
    jp = jax_params(0)[2]
    pp = PV.init_generator(torch.Generator().manual_seed(0), P_VOC)
    assert tree_shapes(pp) == tree_shapes(jp)


@pytest.mark.parametrize("valid", [np.array([24, 7, 15], np.int32), 11])
def test_generator_valid_len_matches_jax(params, valid):
    jp, pp = params
    mel = _mel(1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JV.generator(jp, J_VOC, jnp.asarray(mel), valid_len=jnp.asarray(valid)))
    out = PV.generator(pp, P_VOC, torch.from_numpy(mel), valid_len=torch.as_tensor(valid)).numpy()
    assert out.shape == (3, PV.output_length(P_VOC, 24)) == ref.shape
    assert np.abs(out - ref).max() < TOL


def test_generator_without_valid_len_matches_jax(params):
    jp, pp = params
    mel = _mel(2, b=2, t=10)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JV.generator(jp, J_VOC, jnp.asarray(mel), fuse_tail=False))
    out = PV.generator(pp, P_VOC, torch.from_numpy(mel)).numpy()
    assert np.abs(out - ref).max() < TOL


def test_valid_len_row_equals_exact_length_run(params):
    """Row i's first output_length(n_i) samples equal an exact-length run."""
    _, pp = params
    mel = torch.from_numpy(_mel(3))
    batched = PV.generator(pp, P_VOC, mel, valid_len=torch.tensor([24, 7, 15]))
    for i, n in enumerate((24, 7, 15)):
        exact = PV.generator(pp, P_VOC, mel[i:i + 1, :n])[0]
        m = PV.output_length(P_VOC, n)
        assert (batched[i, :m] - exact).abs().max().item() < TOL


def test_output_length_and_padding():
    assert PV.output_length(PV.VocoderConfig(), 512) == 160 * 512 + 32 == JV.output_length(JV.VocoderConfig(), 512)
    for k, d in ((3, 1), (7, 3), (11, 5)):
        assert PV.get_padding(k, d) == JV.get_padding(k, d)


def test_fuse_tail_matches_unfused_jax(params):
    """fuse_tail=True no longer raises: the fused stage and tail run (their
    plain versions on CPU tensors) and match the JAX package's unfused
    generator, whose f32 arithmetic they repeat."""
    jp, pp = params
    mel = _mel(4, b=2, t=10)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JV.generator(jp, J_VOC, jnp.asarray(mel), fuse_tail=False))
    out = PV.generator(pp, P_VOC, torch.from_numpy(mel), fuse_tail=True).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < TOL
