"""Host-side batch loading: a prefetch thread, fixed-shape numpy batches,
a per-process shard of the records, and a loader state that a resumed run
restores.

Counterpart of ``showo_tpu/data/loader.py`` (its ``DataLoader``,
``default_collate``, ``CheckpointableDataLoader``, ``save_loader_state`` /
``restore_loader_state`` and ``shard_for_process``); the JAX package's
``device_prefetch`` (JAX sharding) has no counterpart: the trainers copy
each batch to the card themselves.  The process index and count of
:func:`shard_for_process` come from ``torch.distributed`` when a process
group is up, else (0, 1).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


def shard_for_process(items: List, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> List:
    """The static shard of ``items`` of one process (DistributedSampler's):
    every ``process_count``-th item from ``process_index``.  A process past
    the end gets one item, wrapped around, never the whole list."""
    if process_index is None:
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if up else 0
        process_count = dist.get_world_size() if up else 1
    shard = items[process_index::process_count]
    if not shard and items:
        shard = [items[process_index % len(items)]]
    return shard


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Samples -> one batch: arrays and scalars stacked, anything else
    (strings) kept as a list."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class DataLoader:
    """Fixed-size batches from a sample iterable, collated by a background
    thread that keeps up to ``prefetch`` batches ready.  The last partial
    batch is dropped (static shapes).  ``num_epochs`` None repeats the
    samples forever."""

    def __init__(self, sample_iter_fn: Callable[[], Iterable],
                 batch_size: int, collate_fn=default_collate,
                 prefetch: int = 2, num_epochs: Optional[int] = None):
        self.sample_iter_fn = sample_iter_fn
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.num_epochs = num_epochs

    def _epoch_iter(self) -> Iterator:
        if self.num_epochs is None:
            while True:
                yield from self.sample_iter_fn()
        else:
            for _ in range(self.num_epochs):
                yield from self.sample_iter_fn()

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            batch = []
            try:
                for sample in self._epoch_iter():
                    if sample is None:
                        continue
                    batch.append(sample)
                    if len(batch) == self.batch_size:
                        q.put(self.collate_fn(batch))
                        batch = []
            except Exception as e:  # raised again in the consumer
                q.put(e)
            q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, Exception):
                raise item
            yield item


class CheckpointableDataLoader(DataLoader):
    """A DataLoader that counts the batches it has yielded and, after
    :meth:`load_state_dict`, skips that many of its (deterministic) stream
    on the next pass."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batches_yielded = 0
        self._pending_skip = 0

    def state_dict(self) -> dict:
        return {"batches_yielded": self.batches_yielded}

    def load_state_dict(self, sd: dict) -> None:
        self._pending_skip = int(sd["batches_yielded"])
        self.batches_yielded = self._pending_skip

    def __iter__(self):
        skip, self._pending_skip = self._pending_skip, 0
        for batch in super().__iter__():
            if skip > 0:
                skip -= 1
                continue
            self.batches_yielded += 1
            yield batch


def _state_path(output_dir: str, step: int, name: str) -> str:
    return os.path.join(output_dir, f"checkpoint-{step}",
                        f"{name}_state.json")


def save_loader_state(loader, output_dir: str, step: int,
                      name: str = "loader") -> str:
    """Write ``loader.state_dict()`` as JSON beside the step's checkpoint
    (``checkpoint-<step>/<name>_state.json``); returns the path."""
    path = _state_path(output_dir, step, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(loader.state_dict(), f)
    return path


def restore_loader_state(loader, output_dir: str, step: int,
                         name: str = "loader") -> bool:
    """Load the state :func:`save_loader_state` wrote at ``step`` into
    ``loader``; False when there is none."""
    path = _state_path(output_dir, step, name)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        loader.load_state_dict(json.load(f))
    return True
