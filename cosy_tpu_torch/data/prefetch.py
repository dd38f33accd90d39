"""Background-thread batch prefetching (the port of the JAX package's
``data/prefetch.py``).

The reference overlaps host-side data prep with device compute through
DataLoader worker processes (train_joint.py:290-298, num_workers).  Here a
daemon thread fills a small bounded queue, so parquet decode, augmentation
and collation of batch N+1 run while the card executes step N.  A thread
suffices because the heavy work is numpy / pyarrow, which release the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional


class _Sentinel:
    pass


_DONE = _Sentinel()


class PrefetchIterator:
    """Wrap any batch iterable; a daemon thread pulls up to ``depth`` batches
    ahead, in order.  An exception in the source re-raises in the consumer
    after the batches before it.  ``close()`` stops the thread, also when it
    is blocked on a full queue."""

    def __init__(self, source: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def put(item) -> bool:
            """Block until the item is queued or ``close()``; False if closed."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in source:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001
                self._err = e
            put(_DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            self._thread.join(timeout=5)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the worker and drop what it queued; True once it has exited
        (within ``timeout`` seconds, unless the source itself blocks)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()


def prefetch(source: Iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(source, depth)
