"""Background-thread batch prefetcher (kpdiff_tpu/data/prefetch.py): host
padding and collation overlap the device step through a bounded queue.
The consumer's wait on the queue is the tracer's span data.wait, and each
batch handed over counts in data.batches (utils/profiling.py)."""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from kpdiff_tpu_torch.utils import profiling


class Prefetcher:
    """Iterates `iterable` on a daemon thread, at most `depth` items ahead;
    an exception in the producer is raised to the consumer."""

    _DONE = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._it = iter(iterable)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # handed to the consumer, which re-raises it
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self) -> Iterator:
        while True:
            with profiling.span("data.wait"):
                item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            profiling.count("data.batches")
            yield item


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    return iter(Prefetcher(iterable, depth))
