"""Parquet text-stream dataset (parquet/refinedweb_dataset.py) on pyarrow.

Counterpart of ``showo_tpu/data/refinedweb.py`` (the reference leans on
an internal package its repository lacks, refinedweb_dataset.py:20): the
rows of the files a glob names, every ``world_size``-th from ``rank``,
newlines removed, and a text longer than ``max_length`` characters cut to
a window of that length at a start from ``random.Random(seed + rank)``
(:38-53).
"""

from __future__ import annotations

import glob
import random
from typing import Iterator


class RefinedWebDataset:
    def __init__(self, data_path: str, rank: int = 0, world_size: int = 1,
                 max_length: int = 8000, text_column: str = "content",
                 seed: int = 0):
        self.files = (sorted(glob.glob(data_path))
                      if any(c in data_path for c in "*?[") else [data_path])
        if not self.files:
            raise FileNotFoundError(data_path)
        self.rank = rank
        self.world_size = world_size
        self.max_length = max_length
        self.text_column = text_column
        self.rng = random.Random(seed + rank)

    def __iter__(self) -> Iterator[dict]:
        import pyarrow.parquet as pq

        for path in self.files:
            row = 0
            for batch in pq.ParquetFile(path).iter_batches(
                    columns=[self.text_column]):
                for text in batch.column(0).to_pylist():
                    if row % self.world_size == self.rank and text:
                        yield {"input_ids": self._crop(text)}
                    row += 1

    def _crop(self, text: str) -> str:
        text = text.replace("\n", "")
        if len(text) > self.max_length:
            start = self.rng.randint(0, len(text) - self.max_length - 1)
            text = text[start:start + self.max_length]
        return text
