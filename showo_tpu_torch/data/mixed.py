"""Several loaders as one stream (show-o2/datasets/mixed_dataloader.py
:33-155).

Counterpart of ``showo_tpu/data/mixed.py``.  Modes:
  max_size_cycle            a weighted random pick of a loader per
                            sub-batch, short loaders wrap around;
  min_size                  the same, stopping when a loader runs out;
  concat_max_size_cycle     one batch of each loader per step,
                            concatenated along the batch (the Show-o2
                            stage trainers' mode);
  concat_min_size           the same, stopping at the shortest;
  sequential_max_size_cycle round robin over the loaders.
The cycling modes end once every loader has run out at least once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _concat_batches(batches: Sequence[Dict]) -> Dict:
    out: Dict = {}
    for k in batches[0]:
        vals = [b[k] for b in batches]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.concatenate(vals, axis=0)
        else:
            out[k] = [x for v in vals for x in v]
    return out


class MixedDataLoader:
    def __init__(self, loaders: Sequence, mode: str = "concat_max_size_cycle",
                 weights: Optional[Sequence[float]] = None, seed: int = 0,
                 accumulation: int = 1):
        self.loaders = list(loaders)
        self.mode = mode
        self.weights = (np.asarray(weights, np.float64) / np.sum(weights)
                        if weights is not None
                        else np.full(len(loaders), 1 / len(loaders)))
        self.rng = np.random.default_rng(seed)
        self.accumulation = max(1, accumulation)

    def state_dict(self) -> dict:
        """The sampling generator's state and each loader's position."""
        return {"rng_state": self.rng.bit_generator.state,
                "loaders": [ld.state_dict() if hasattr(ld, "state_dict")
                            else None for ld in self.loaders]}

    def load_state_dict(self, sd: dict) -> None:
        self.rng.bit_generator.state = sd["rng_state"]
        for ld, s in zip(self.loaders, sd["loaders"]):
            if s is not None and hasattr(ld, "load_state_dict"):
                ld.load_state_dict(s)

    def __iter__(self):
        iters = [iter(ld) for ld in self.loaders]
        exhausted = [False] * len(iters)

        def pull(i, cycle: bool):
            try:
                return next(iters[i])
            except StopIteration:
                exhausted[i] = True
                if not cycle:
                    return None
                iters[i] = iter(self.loaders[i])
                return next(iters[i])

        def picks(cycle):
            batches = []
            for _ in range(self.accumulation):
                i = int(self.rng.choice(len(iters), p=self.weights))
                b = pull(i, cycle)
                if b is None:
                    return None
                batches.append(b)
            return batches[0] if len(batches) == 1 \
                else _concat_batches(batches)

        if self.mode in ("max_size_cycle", "min_size"):
            cycle = self.mode == "max_size_cycle"
            while True:
                batch = picks(cycle)
                if batch is None:
                    return
                yield batch
                if cycle and all(exhausted):
                    return
        elif self.mode in ("concat_max_size_cycle", "concat_min_size"):
            cycle = self.mode == "concat_max_size_cycle"
            while True:
                batches = []
                for i in range(len(iters)):
                    b = pull(i, cycle)
                    if b is None:
                        return
                    batches.append(b)
                if cycle and all(exhausted):
                    return
                yield _concat_batches(batches)
        elif self.mode == "sequential_max_size_cycle":
            i = 0
            while True:
                yield pull(i % len(iters), cycle=True)
                if all(exhausted):
                    return
                i += 1
        else:
            raise ValueError(f"unknown mode {self.mode}")
