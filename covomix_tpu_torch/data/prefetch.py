"""Host-side input prefetching (the port's copy of the iterator in
covomix_tpu/data/prefetch.py): one producer thread fills a bounded queue
while the consumer runs device steps; disk IO and numpy padding release the
GIL, so they overlap the step."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class _Stop:
    pass


_STOP = _Stop()


class PrefetchIterator:
    """Wrap an iterator with one producer thread and a bounded buffer.
    Preserves order; an exception in the producer is raised on the consumer
    side."""

    def __init__(self, it: Iterator, buffer_size: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def produce():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
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
