"""Prefetching batch loader — the torch-DataLoader-worker role (a copy of
``sonicsim_tpu.dataset.loader``).

The reference feeds training through DataLoader(num_workers=...) processes
(separation/look2hear/datas/movingdatamodule.py:352-377). Here, as in the
JAX package, the equivalent is a thread pool + bounded queue: a worker pool
indexes the dataset directly, a single consumer keeps batch order, and the
queue keeps ``prefetch`` batches ready so host data prep overlaps the
device's step (the trainer moves each numpy batch to the device). The
port's WAV reader is numpy over the file's bytes, so the threads overlap
file reads more than decoding.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np

_SENTINEL = object()


def prefetch_iter(make_iter: Callable[[], Iterable], depth: int = 2) -> Iterator:
    """Run ``make_iter()`` in a background thread, keeping up to ``depth``
    items ready. Exceptions re-raise in the consumer.

    If the consumer abandons the generator early (break / close), the
    producer thread is signalled through ``stop`` and exits at its next
    queue interaction instead of blocking forever on a full queue.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in make_iter():
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            _put(e)
            return
        _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def batched_loader(
    dataset,
    batch_size: int,
    num_workers: int = 0,
    prefetch: int = 2,
    collate: Callable | None = None,
) -> Iterator:
    """Yield collated batches of ``dataset[i]`` in index order.

    num_workers=0 reproduces the plain synchronous loop; num_workers>=1
    fans ``__getitem__`` over a thread pool and a prefetch queue
    overlaps host prep with device compute.
    """
    n = len(dataset)
    if collate is None:
        collate = _default_collate

    def batches_sync():
        buf = []
        for i in range(n):
            buf.append(dataset[i])
            if len(buf) == batch_size:
                yield collate(buf)
                buf = []
        if buf:
            yield collate(buf)

    if num_workers <= 0:
        yield from batches_sync()
        return

    # Bound in-flight decode: a sliding window of at most
    # num_workers + batch_size submitted futures, popping the oldest
    # (consuming it) before submitting the next. Without the window,
    # ThreadPoolExecutor.map would create all n futures up front and the
    # workers would decode the whole epoch ahead of the consumer.
    window = num_workers + batch_size

    def batches_pooled():
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            pending: deque = deque()
            buf = []
            it = iter(range(n))
            for i in it:
                pending.append(pool.submit(dataset.__getitem__, i))
                if len(pending) < window:
                    continue
                buf.append(pending.popleft().result())
                if len(buf) == batch_size:
                    yield collate(buf)
                    buf = []
            while pending:
                buf.append(pending.popleft().result())
                if len(buf) == batch_size:
                    yield collate(buf)
                    buf = []
            if buf:
                yield collate(buf)

    yield from prefetch_iter(batches_pooled, depth=prefetch)


def _default_collate(items):
    first = items[0]
    if isinstance(first, tuple):
        return tuple(
            np.stack([np.asarray(it[k]) for it in items])
            for k in range(len(first))
        )
    return np.stack([np.asarray(it) for it in items])
