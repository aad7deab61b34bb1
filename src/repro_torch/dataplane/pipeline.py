"""Prefetching pipeline.

A background thread keeps ``depth`` batches ahead so the card never
waits on the host's batch making or planning.  Step-addressable sources
make fault-tolerant replay deterministic (``repro_torch.train.fault``).

:class:`CachedExtractionSource` routes a step's polytope requests
through a shared :class:`~repro_torch.serve.extraction.ExtractionService`,
so request geometry that recurs across steps is served from the plan
cache instead of re-running Algorithm 1.  ``device_put`` places a host
batch on the card: one pinned buffer and one non-blocking copy
(``_device.upload``); ``device_put_sharded`` places it on a mesh, as
``DTensor`` tensors by a tree of ``distributed.sharding.named`` placements.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .._device import upload


class Prefetcher:
    def __init__(self, source: Callable[[int], Any], depth: int = 2,
                 start_step: int = 0, put_fn: Callable | None = None):
        self.source = source
        self.depth = depth
        self.put_fn = put_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.put_fn(self.source(step))
            except Exception as e:  # surface errors on the main thread
                self._q.put(e)
                return
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class CachedExtractionSource:
    """Step-addressable batch source planned through a shared service.

    ``request_fn(step)`` returns the step's polytope request(s); the
    whole list is submitted as ONE service batch, so duplicate geometry
    inside a step is planned once and overlapping reads coalesce, while
    geometry repeated across steps (the same crops every cycle) hits the
    plan cache.  Made to be the ``source`` of a :class:`Prefetcher`: the
    service is thread-safe, so planning runs on the prefetch thread while
    the card trains.
    """

    def __init__(self, service, request_fn: Callable[[int], Any],
                 flat_data: Any | None = None,
                 collate: Callable[[int, list], Any] | None = None):
        self.service = service
        self.request_fn = request_fn
        self.flat_data = flat_data
        self.collate = collate

    def __call__(self, step: int) -> Any:
        reqs = self.request_fn(step)
        single = not isinstance(reqs, (list, tuple))
        batch = [reqs] if single else list(reqs)
        results = self.service.submit_batch(batch, self.flat_data)
        if self.collate is not None:
            return self.collate(step, results)
        return results[0] if single else results


def device_put(batch: dict, device: "torch.device | str") -> dict:
    """A host batch (a dict of numpy arrays) as tensors on ``device``,
    all of them in one pinned buffer and one non-blocking copy."""
    device = torch.device(device)
    keys = list(batch)
    tensors = upload(device, *(np.asarray(batch[k]) for k in keys))
    return dict(zip(keys, tensors))


def device_put_sharded(batch: Any, shardings: Any) -> Any:
    """Place a batch onto the mesh: each tensor leaf through
    ``distribute_tensor`` with its ``NamedSharding`` (the matching leaf of
    ``shardings``, from ``sharding.named``).  Every rank passes the whole
    batch, and each keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    from ..distributed.sharding import tree_map

    def put(x, s):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return distribute_tensor(t.to(s.device_mesh.device_type),
                                 s.device_mesh, s.placements)

    return tree_map(put, batch, shardings)
