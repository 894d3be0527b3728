"""Host-side batch loading: a prefetch thread, fixed-shape numpy batches,
a per-process shard of the records, and a loader state that a resumed run
restores.

Counterpart of ``showo_tpu/data/loader.py`` (its ``DataLoader``,
``default_collate``, ``CheckpointableDataLoader``, ``save_loader_state`` /
``restore_loader_state``, ``shard_for_process`` and ``ShuffleBuffer``); the
JAX package's
``device_prefetch`` (JAX sharding) has no counterpart: the trainers copy
each batch to the card themselves.  The process index and count of
:func:`shard_for_process` are the caller's, or by default
``torch.distributed``'s when a process group is up, else (0, 1); a
trainer passes its model's :func:`data_shard` to its datasets.
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
        process_index, process_count = process_rank()
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


def process_rank() -> tuple:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is up, else (0, 1).  A trainer on a mesh gives its
    loaders :func:`data_shard` of its model instead."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_shard(model) -> tuple:
    """(rank, world size) of the rows that ``model``'s steps take: on a
    model sharded over a ("dp", "fsdp", "tp") mesh (``parallel/mesh.py::
    shard_params`` keeps it as ``model.mesh_info``) its data rank and
    world, so the tp ranks of a (dp, fsdp) coordinate read the same rows;
    else :func:`process_rank`."""
    info = getattr(model, "mesh_info", None)
    if info is None:
        return process_rank()
    return info.data_rank, info.data_world


def loader_name(model, name: str) -> str:
    """The name a loader's state is saved under: ``name``, or on a
    sharded model with several data ranks ``<name>_rank<data rank>`` (each
    data rank reads its own rows)."""
    info = getattr(model, "mesh_info", None)
    if info is None or info.data_world == 1:
        return name
    return f"{name}_rank{info.data_rank}"


def loader_writer(model) -> bool:
    """Whether this process writes its loaders' states: on a sharded model
    tp rank 0 of its data rank (the other tp ranks hold the same rows),
    else every process."""
    info = getattr(model, "mesh_info", None)
    return info is None or info.coord["tp"] == 0


class ShuffleBuffer:
    """A reservoir shuffle of a stream (webdataset's ``.shuffle``): keep
    ``size`` items, yield a random one of them for each new item, and the
    rest shuffled at the end; the draws from
    ``np.random.default_rng(seed)``, as JAX's."""

    def __init__(self, iterable: Iterable, size: int, seed: int = 0):
        self.iterable = iterable
        self.size = size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        buf: List = []
        for item in self.iterable:
            if len(buf) < self.size:
                buf.append(item)
                continue
            idx = int(self.rng.integers(0, self.size))
            out, buf[idx] = buf[idx], item
            yield out
        self.rng.shuffle(buf)
        yield from buf
