"""Names of the JAX package that the port carries under the same name and
arguments: the `audio` package's namespace, the parameter-init helpers of
`models/layers.py`, and `data_loader(transfer=)`."""

import math

import jax
import numpy as np
import pytest
import torch

import covomix_tpu.audio as JAudio
from covomix_tpu.data import datasets as JD
from covomix_tpu.models import layers as JL
import covomix_tpu_torch.audio as PAudio
from covomix_tpu_torch.data import datasets as PD
from covomix_tpu_torch.models import acoustic as PA, layers as PL


def test_audio_namespace_holds_the_jax_packages():
    """Every name of `covomix_tpu.audio.__all__` is in the port's `__all__`
    and importable from `covomix_tpu_torch.audio`; the constant is JAX's."""
    assert set(JAudio.__all__) <= set(PAudio.__all__)
    for name in PAudio.__all__:
        assert getattr(PAudio, name) is not None, name
    assert PAudio.log_mel_floor == JAudio.log_mel_floor == math.log(1e-5)
    from covomix_tpu_torch.audio import get_window, istft, spec_back, spec_fwd, stft_complex  # noqa: F401


# helper -> (JAX call, port call, bound of a uniform draw or None), at the
# same shapes
INITS = {
    "linear_init": (lambda k: JL.linear_init(k, 64, 256, scale=0.5),
                    lambda g: PL.linear_init(g, 64, 256, scale=0.5), 0.5 / 8),
    "linear_init_no_bias": (lambda k: JL.linear_init(k, 64, 96, bias=False),
                            lambda g: PL.linear_init(g, 64, 96, bias=False), 1 / 8),
    "embedding_init": (lambda k: JL.embedding_init(k, 50, 16), lambda g: PL.embedding_init(g, 50, 16), None),
    "conv1d_init": (lambda k: JL.conv1d_init(k, 32, 48, 5, groups=2),
                    lambda g: PL.conv1d_init(g, 32, 48, 5, groups=2), 1 / math.sqrt(5 * 16)),
    "rmsnorm_init": (lambda k: JL.rmsnorm_init(24), lambda g: PL.rmsnorm_init(24), None),
    "adaptive_rmsnorm_init": (lambda k: JL.adaptive_rmsnorm_init(k, 24, 40),
                              lambda g: PL.adaptive_rmsnorm_init(g, 24, 40), None),
    "layernorm_init": (lambda k: JL.layernorm_init(24), lambda g: PL.layernorm_init(24), None),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_helpers_match_jax_shapes_and_bounds(name):
    """Each helper gives JAX's names, shapes and dtypes; a uniform one stays
    within JAX's bound and comes near it, as JAX's own draw does; a normal
    one has unit scale; the norms' constants are JAX's exactly."""
    jfn, pfn, bound = INITS[name]
    ref = jax.tree_util.tree_map(np.asarray, jfn(jax.random.PRNGKey(0)))
    got = pfn(torch.Generator().manual_seed(0))
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), got))[0])
    assert flat_got.keys() == flat_ref.keys()
    for path, r in flat_ref.items():
        g = flat_got[path]
        assert g.shape == r.shape and g.dtype == r.dtype == np.float32, path
        if bound is not None:
            for x in (g, r):   # near the bound where the leaf has enough draws to reach it
                top = np.abs(x).max()
                assert top <= bound and (x.size < 1024 or top >= 0.97 * bound), (path, top, bound)
        elif name == "embedding_init":
            assert 0.8 < g.std() < 1.2 and 0.8 < r.std() < 1.2
        else:
            np.testing.assert_array_equal(g, r)


def test_acoustic_keeps_the_init_names():
    """models/acoustic.py's init names are layers.py's helpers; HuBERT, the
    vocoder and T2S import them from layers.py."""
    from covomix_tpu_torch.models import hubert, text2semantic, vocoder

    for name in ("linear_init", "conv1d_init", "adaptive_rmsnorm_init"):
        assert getattr(PA, name) is getattr(PL, name)
    assert vocoder.conv1d_init is hubert.conv1d_init is PL.conv1d_init
    assert text2semantic.linear_init is hubert.linear_init is PL.linear_init


def _dataset(n=7):
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(3).astype(np.float32), "i": i} for i in range(n)]


def _collate(items):
    return {"x": np.stack([it["x"] for it in items]), "i": np.array([it["i"] for it in items])}


def test_data_loader_passes_transfer_to_its_worker():
    """`transfer` runs on every batch in the prefetch worker (num_workers >
    0), as JAX's data_loader hands it to its PrefetchIterator; the batches
    and their order are the plain loader's and JAX's."""
    ds = _dataset()
    seen = []

    def transfer(batch):
        seen.append(batch["i"].tolist())
        return {k: torch.as_tensor(v) for k, v in batch.items()}

    plain = PD.data_loader(ds, 2, _collate, seed=4)
    jax_loader = JD.data_loader(ds, 2, _collate, seed=4)
    loader = PD.data_loader(ds, 2, _collate, seed=4, num_workers=2, transfer=transfer)
    order = []
    try:
        for _ in range(5):
            got, ref, jref = next(loader), next(plain), next(jax_loader)
            assert isinstance(got["x"], torch.Tensor)
            assert np.array_equal(got["x"].numpy(), ref["x"]) and np.array_equal(got["i"].numpy(), jref["i"])
            order.append(ref["i"].tolist())
    finally:
        loader.close()
    assert seen[:5] == order
