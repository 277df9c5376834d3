"""Background-prefetch data loader.

The host in this class of deployment is thin (often one core) while the
accelerator is hungry; a loader that decodes/assembles the next batch while
the device computes the current one keeps the feed off the critical path.
Threaded (ingest decode is numpy work that releases the GIL).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


class PrefetchLoader:
    """Wrap any batch iterator with an N-deep background prefetch queue."""

    _DONE = object()

    def __init__(self, it: Iterable[T], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._fill, args=(iter(it),), daemon=True)
        self._thread.start()

    def _fill(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def batched(items: list, batch_size: int, make_batch: Callable):
    """Yield make_batch(chunk) over fixed-size chunks (drop-none padding is
    the caller's concern; chunks may be ragged at the tail)."""
    for lo in range(0, len(items), batch_size):
        yield make_batch(items[lo: lo + batch_size])
