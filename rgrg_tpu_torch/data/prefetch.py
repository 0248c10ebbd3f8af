"""Background-thread batch prefetching (the port's own copy).

The reference overlaps data loading with device compute through torch
DataLoader workers (train_full_model.py:320-335). Here a single producer
thread stays one-to-two batches ahead: the caller's device work is
asynchronous, and image decode and the numpy resize release the GIL, so
the producer overlaps with the thread that drives the card.

Usage:
    batches = prefetched(ds.batches(batch_size), depth=2)
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

X = TypeVar("X")

_SENTINEL = object()


def prefetched(it: Iterable[X], depth: int = 2) -> Iterator[X]:
    """Iterate `it` on a daemon producer thread through a bounded queue.

    Yields the same items in the same order. An exception in the producer
    is re-raised at the consumption point where it would have occurred.
    `depth` bounds host memory: at most `depth` batches exist beyond the
    one being consumed (DataLoader's prefetch_factor analogue).

    Abandoning the iterator early (consumer break/raise -> GeneratorExit)
    releases the producer: its bounded put polls a stop flag, so the
    thread exits instead of pinning itself plus `depth` buffered batches
    until process end."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    err = []
    stop = threading.Event()

    def produce():
        try:
            for x in it:
                while True:
                    if stop.is_set():
                        return
                    try:
                        q.put(x, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True,
                         name="rgrg-prefetch")
    t.start()
    try:
        while True:
            x = q.get()
            if x is _SENTINEL:
                t.join()
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()
        while True:  # drain so a put-blocked producer can reach the flag
            try:
                q.get_nowait()
            except queue.Empty:
                break


def prefetched_factory(factory: Callable[[], Iterable[X]],
                       depth: int = 2) -> Callable[[], Iterator[X]]:
    """Wrap a batch-iterator factory (a fresh iterator per epoch) so each
    epoch's iterator is prefetched on its own producer thread."""
    return lambda: prefetched(factory(), depth=depth)
