"""Background-thread batch prefetching (counterpart of
contrastboundary_tpu/data/prefetch.py): a daemon thread prepares the numpy
batches of an iterator ahead of the training loop, into a bounded queue,
while the card runs the previous step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


def prefetch(iterator_factory: Callable[[], Iterator], depth: int = 2) -> Iterator:
    """Run `iterator_factory()` in a daemon thread, buffering `depth` items.
    Producer exceptions propagate to the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator_factory():
                q.put(item)
            q.put(_END)
        except BaseException as e:  # re-raised on the consumer side
            q.put(("__prefetch_error__", e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
            raise item[1]
        yield item
