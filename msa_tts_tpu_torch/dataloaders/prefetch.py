"""Host → device input prefetching (counterpart of
``msa_tts_tpu/dataloaders/prefetch.py``).

A producer thread takes items from the iterable (collating them, where
the iterable is a loader) and turns their numpy arrays into tensors, in
pinned host memory when the device is a GPU, keeping up to ``size``
items ready.  The consumer, on the training thread, starts the copy of
the next item onto the device (``non_blocking`` on a side stream, an
event recorded after it) before it yields the current one, whose event
the compute stream waits on: the copy of step t + 1 runs under step t,
and no tensor is read before its copy lands.  With ``device="cpu"`` the
items are yielded as host tensors.

Items are trees of dicts, lists and tuples whose leaves are numpy arrays
or tensors (integer arrays become int64 tensors); other leaves (speaker
names) pass through unchanged.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils.backend import load_device

_SENTINEL = object()


def tree_map(fn: Callable, tree):
    """``fn`` on every array or tensor leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def host_tensors(tree, pin: bool = False):
    """``tree`` with its numpy leaves as tensors (integers as int64), in
    pinned memory with ``pin``."""
    def t(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not x.is_floating_point():
            x = x.to(torch.int64)
        return x.pin_memory() if pin else x

    return tree_map(t, tree)


def prefetch_to_device(iterable: Iterable, size: int = 2, device="cuda",
                       threaded: bool = True) -> Iterator:
    """Yield the items of ``iterable`` as tensors on ``device``, with up to
    ``size`` of them built ahead by a producer thread (``threaded=False``:
    built on the consumer's thread, one ahead).  ``device`` is the card
    unless ``device="cpu"`` is asked for; without a CUDA device the
    default raises here, at the call (``utils.backend.load_device``)."""
    return _prefetch(iterable, size, load_device(device), threaded)


def _prefetch(iterable: Iterable, size: int, device: torch.device,
              threaded: bool) -> Iterator:
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def upload(host):
        if not cuda:
            return host
        with torch.cuda.stream(side):
            dev = tree_map(lambda x: x.to(device, non_blocking=True), host)
            ev = torch.cuda.Event()
            ev.record(side)
        return dev, ev

    def ready(pending):
        if not cuda:
            return pending
        dev, ev = pending
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ev)
        # the tensors were allocated on the side stream: keep the
        # allocator from reusing them before the compute stream is done
        tree_map(lambda x: x.record_stream(cur), dev)
        return dev

    def consume(hosts):
        pending = None
        while True:
            try:
                host = next(hosts)
            except StopIteration:
                break
            except BaseException:
                # the items before a failed one still come out first
                if pending is not None:
                    yield ready(pending)
                raise
            nxt = upload(host)
            if pending is not None:
                yield ready(pending)
            pending = nxt
        if pending is not None:
            yield ready(pending)

    it = iter(iterable)
    if not threaded or size <= 0:
        yield from consume(host_tensors(raw, cuda) for raw in it)
        return

    q: _queue.Queue = _queue.Queue(maxsize=size)
    stop = threading.Event()
    err: list = []

    def offer(item) -> bool:
        """Enqueue unless the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            for raw in it:
                if stop.is_set() or not offer(host_tensors(raw, cuda)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised by the consumer
            err.append(e)
        finally:
            offer(_SENTINEL)

    def hosts():
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item

    t = threading.Thread(target=producer, daemon=True,
                         name="prefetch_to_device")
    t.start()
    try:
        yield from consume(hosts())
    finally:
        stop.set()
