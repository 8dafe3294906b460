"""Host-side input prefetching (port of covomix_tpu/data/prefetch.py):
producer threads fill a bounded queue while the consumer runs device steps;
disk IO and numpy padding release the GIL, so they overlap the step. A
`transfer` (e.g. `device_transfer("cuda")`) runs in the producer, so the
host-to-device copy of the next batch overlaps the step too."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


class _Stop:
    pass


_STOP = _Stop()


class PrefetchIterator:
    """Wrap an iterator with one producer thread and a bounded buffer.
    Preserves order; an exception in the producer is raised on the consumer
    side. `transfer` runs on each item in the producer thread."""

    def __init__(self, it: Iterator, buffer_size: int = 2, transfer: Optional[Callable[[Any], Any]] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def produce():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    if transfer is not None:
                        item = transfer(item)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                try:
                    self._q.put(_STOP, timeout=5)
                except queue.Full:
                    pass

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Stop):
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class PrefetchSampler:
    """N worker threads each repeatedly call `make_batch(worker_seed)` into a
    bounded queue: DataLoader(num_workers=N) for datasets drawn i.i.d. per
    step (hifi-gan's MelDataset with shuffle). Batch order across workers is
    nondeterministic; each worker's stream is reproducible (seeds hashed from
    (seed, worker, n) by np.random.SeedSequence). A worker's exception stops
    the sampler and is raised on the consumer side."""

    def __init__(self, make_batch: Callable[[int], Any], num_workers: int = 1, buffer_size: int = 2,
                 transfer: Optional[Callable[[Any], Any]] = None, seed: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._threads = []

        def work(worker_id: int):
            n = 0
            try:
                while not self._stop.is_set():
                    # a linear combination of (seed, worker, n) would replay
                    # another worker's batches once n grows; SeedSequence hashes it
                    batch = make_batch(int(np.random.SeedSequence((seed, worker_id, n)).generate_state(1)[0]))
                    n += 1
                    if transfer is not None:
                        batch = transfer(batch)
                    while not self._stop.is_set():
                        try:
                            self._q.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
                self._stop.set()

        for w in range(max(1, num_workers)):
            t = threading.Thread(target=work, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._err is not None:
                    raise self._err
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def device_transfer(device):
    """A transfer moving every array of a batch dict to `device` as a tensor.
    For a CUDA device the host array is pinned and copied without blocking,
    on the current stream of the calling thread (the default stream, which
    the consumer's step also runs on, so the step reads the batch after the
    copy). No fallback: a failing copy raises in the worker and so in the
    consumer."""
    device = torch.device(device)

    def transfer(batch):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        return out

    return transfer
