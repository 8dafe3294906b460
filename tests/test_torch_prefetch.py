"""The port's prefetch loaders (covomix_tpu_torch/data/prefetch.py), as
tests/test_prefetch.py holds the JAX package's: order, error propagation,
worker seeds and overlap, and the transfer that runs in the producer
(`device_transfer`: tensors on the device, or the copy's error raised in the
consumer)."""

import time

import numpy as np
import pytest
import torch

from covomix_tpu.data import prefetch as JP
from covomix_tpu_torch.data.prefetch import PrefetchIterator, PrefetchSampler, device_transfer


def test_iterator_preserves_order_and_stops():
    assert list(PrefetchIterator(iter(range(50)), buffer_size=4)) == list(range(50))


def test_iterator_transfer_runs_in_producer():
    seen = []
    it = PrefetchIterator(iter([1, 2, 3]), transfer=lambda x: (seen.append(x), x * 10)[1])
    assert list(it) == [10, 20, 30]
    assert seen == [1, 2, 3]


def test_iterator_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_sampler_seeds_match_jax_package():
    """One worker draws the JAX package's seed stream, (seed, worker, n)
    hashed by SeedSequence; two workers never repeat a seed."""
    one = [PrefetchSampler(lambda s: s, num_workers=1, buffer_size=1, seed=7),
           JP.PrefetchSampler(lambda s: s, num_workers=1, buffer_size=1, seed=7)]
    got = [[next(loader) for _ in range(6)] for loader in one]
    for loader in one:
        loader.close()
    assert got[0] == got[1]

    def make_batch(seed):
        rng = np.random.RandomState(seed % (2 ** 31))
        return {"x": rng.randn(4, 8).astype(np.float32), "seed": seed}

    loader = PrefetchSampler(make_batch, num_workers=2, buffer_size=3, seed=7)
    seeds = set()
    for _ in range(10):
        b = next(loader)
        assert b["x"].shape == (4, 8)
        seeds.add(b["seed"])
    loader.close()
    assert len(seeds) == 10


def test_sampler_propagates_errors():
    def bad(seed):
        raise ValueError("nope")

    loader = PrefetchSampler(bad, num_workers=1)
    with pytest.raises(ValueError, match="nope"):
        next(loader)


def test_sampler_overlaps_slow_producer():
    """Two workers of ~50 ms each: 8 batches well under 8 x 50 ms."""

    def slow(seed):
        time.sleep(0.05)
        return seed

    loader = PrefetchSampler(slow, num_workers=2, buffer_size=2)
    next(loader)
    t0 = time.time()
    for _ in range(8):
        next(loader)
    elapsed = time.time() - t0
    loader.close()
    assert elapsed < 8 * 0.05 * 0.9, elapsed


def test_device_transfer_cpu():
    loader = PrefetchSampler(lambda s: {"audio": np.full((2, 3), s % 7, np.float32), "ids": np.arange(3)},
                             transfer=device_transfer("cpu"))
    b = next(loader)
    loader.close()
    assert isinstance(b["audio"], torch.Tensor) and b["audio"].dtype == torch.float32
    assert b["ids"].dtype == torch.int64 and b["audio"].device.type == "cpu"


def test_device_transfer_cuda_lands_on_the_card_or_raises():
    """On a CUDA machine the batch arrives on the card; without one the
    pinning / copy fails in the worker and the consumer sees that error, not
    a batch left on the CPU."""
    loader = PrefetchSampler(lambda s: {"audio": np.ones((2, 3), np.float32)}, transfer=device_transfer("cuda"))
    try:
        if torch.cuda.is_available():
            assert next(loader)["audio"].device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                next(loader)
    finally:
        loader.close()
