"""Host -> device prefetch with a bounded queue.

Counterpart of `omnibiote_tpu/data/prefetch.py` (the reference's loader
thread, Queue(maxsize=2)): a background thread pulls the next items from
an iterator and, for a CUDA device, stages every numpy array or CPU tensor
in them in pinned memory and copies it to the device on a side CUDA
stream, recording an event. The consumer's stream waits on that event
before the item is handed out, so the next batch's copy overlaps the
current step's compute without a host synchronisation. Anything that is
not an array (a list of floats, an int) passes through unchanged.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def _map_arrays(item, fn):
    if isinstance(item, dict):
        return {k: _map_arrays(v, fn) for k, v in item.items()}
    if isinstance(item, tuple):
        return tuple(_map_arrays(v, fn) for v in item)
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    return item


class DevicePrefetcher:
    """Background thread that moves upcoming items to `device` (None: the
    GPU). depth=2 matches the reference's Queue(maxsize=2)."""

    def __init__(self, batch_iter: Iterator, device=None, depth: int = 2):
        self._iter = batch_iter
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, item):
        """(item on the device, the copy's CUDA event or None)."""
        def host(x):
            return torch.from_numpy(np.ascontiguousarray(x)) \
                if isinstance(x, np.ndarray) else x

        if self._stream is None:
            return _map_arrays(item, lambda x: host(x).to(self._device)), None
        with torch.cuda.stream(self._stream):
            out = _map_arrays(item, lambda x: host(x).pin_memory().to(
                self._device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self):
        try:
            for item in self._iter:
                if self._stop.is_set():
                    return
                staged = self._to_device(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the next __next__
            self._exc = e
        finally:
            # the sentinel put respects _stop too: a blocking put on a full
            # queue with no consumer left would pin this thread forever
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        # once exhausted (or closed), stay exhausted: the single sentinel is
        # consumed exactly once
        if self._done or self._stop.is_set():
            raise StopIteration
        staged = self._q.get()
        if staged is None:
            self._done = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        item, event = staged
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            # the copies were allocated on the side stream: tell the
            # allocator the consumer's stream uses them too
            _map_arrays(item, lambda t: t.record_stream(consumer))
        return item

    def close(self, join_timeout: float = 5.0):
        """Stop the worker, drain the queue and join the thread.
        Idempotent; every owner must call it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # wake a consumer already blocked in _q.get()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            warnings.warn(
                f"DevicePrefetcher worker still alive after {join_timeout}s "
                "join (wedged in batch assembly or a copy)", RuntimeWarning)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
