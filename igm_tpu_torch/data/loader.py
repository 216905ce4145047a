"""Host batch iteration and device prefetch.

Counterpart of ``igm_tpu/data/loader.py``.  An epoch is one permutation
drawn from the caller's ``np.random.Generator`` (the trainer's, seeded as
``igm_tpu``'s, so the batch order is the same), batches are gathered with
numpy indexing into contiguous uint8 arrays, :func:`chunk_batches` stacks
K of them for a chained execution (``steps_per_execution``), and
:class:`DevicePrefetcher` stages the next batches (or chunks, each array
one copy) on the device while the current step runs.
``igm_tpu``'s C++ gather (``data/native.py``) is not ported.

A prefetch worker's exception is re-raised in the training loop: a dying
worker fails the epoch, it never shortens it.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


def epoch_batches(arrays: Sequence[np.ndarray], batch_size: int,
                  rng: Optional[np.random.Generator] = None,
                  shuffle: bool = False,
                  limit: Optional[int] = None) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield host batch tuples of exactly ``min(batch_size, rows)`` rows, the
    remainder dropped; ``shuffle`` takes one ``rng.permutation`` per call."""
    n = len(arrays[0])
    bs = min(int(batch_size), n)
    if bs <= 0:
        raise ValueError(f"cannot form a batch of {batch_size} from {n} rows")
    if shuffle:
        if rng is None:
            raise ValueError("shuffle needs an rng")
        order = rng.permutation(n).astype(np.int64)
    else:
        order = np.arange(n, dtype=np.int64)
    n_batches = n // bs
    if limit is not None:
        n_batches = min(n_batches, int(limit))
    for i in range(n_batches):
        idx = order[i * bs:(i + 1) * bs]
        yield tuple(np.ascontiguousarray(a[idx]) for a in arrays)


def chunk_batches(batches: Iterable, k: int) -> Iterator[Tuple[np.ndarray, ...]]:
    """Stack K consecutive batches into one ``[k, B, ...]`` chunk for
    chained execution (the trainer's ``steps_per_execution``), as
    ``igm_tpu/data/loader.py:58-71`` does.  A shorter tail chunk is yielded
    as it is."""
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield tuple(np.stack([bb[j] for bb in buf]) for j in range(len(buf[0])))
            buf = []
    if buf:
        yield tuple(np.stack([bb[j] for bb in buf]) for j in range(len(buf[0])))


class DevicePrefetcher:
    """Iterate device-resident batches; the copies overlap the current step.

    A worker thread turns host batches into tensors and, for a CUDA device,
    copies them from pinned memory on a side stream, keeping up to two
    batches in flight.  The consumer's stream waits for a batch's copy
    before its first use.  Worker exceptions are re-raised at the consuming
    ``__next__``.
    """

    _SENTINEL = object()

    def __init__(self, batches: Iterable, device: torch.device):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=2)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(iter(batches),),
                                        daemon=True)
        self._thread.start()

    def _stage(self, batch):
        host = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            dev = tuple(t.pin_memory().to(self._device, non_blocking=True)
                        for t in host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _worker(self, it) -> None:
        try:
            for batch in it:
                self._q.put(self._stage(batch))
        except BaseException as exc:  # re-raised in __next__: never truncate an epoch
            self._exc = exc
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in batch:
                t.record_stream(current)
        return batch
