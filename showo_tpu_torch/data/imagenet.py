"""Class-conditional ImageNet "t2i" dataset (training/imagenet_dataset.py).

Counterpart of ``showo_tpu/data/imagenet.py``: one folder a class, the
caption the class name from a mapping file ("<synset> <name>" lines) or
the folder's name; an image that fails to load passes to the next index
(:54-67, ten tries).  The order is shuffled by ``random.Random(seed)``; each process reads
every n-th sample of it (``data/loader.py::shard_for_process``).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Dict, List, Optional, Tuple

from showo_tpu_torch.data.loader import process_rank, shard_for_process

from showo_tpu_torch.utils.image import image_transform

logger = logging.getLogger(__name__)


def load_label_mapping(path: Optional[str]) -> Dict[str, str]:
    mapping: Dict[str, str] = {}
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if len(parts) == 2:
                    mapping[parts[0]] = parts[1]
    return mapping


class ImageNetDataset:
    def __init__(self, root: str, resolution: int = 256,
                 label_mapping_path: Optional[str] = None, seed: int = 0,
                 shuffle: bool = True,
                 process: Optional[Tuple[int, int]] = None):
        """process: (index, count) of this process's rows of the order
        (``data/loader.py::process_rank`` by default)."""
        self.root = root
        self.resolution = resolution
        self.mapping = load_label_mapping(label_mapping_path)
        self.samples: List = []
        for cls in sorted(os.listdir(root)):
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir):
                continue
            name = self.mapping.get(cls, cls.replace("_", " "))
            for fn in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fn), name))
        self.rng = random.Random(seed)
        self.shuffle = shuffle
        self.process = tuple(process or process_rank())

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image

        for attempt in range(10):
            path, name = self.samples[(idx + attempt) % len(self.samples)]
            try:
                img = Image.open(path).convert("RGB")
                return {"image": image_transform(img, self.resolution),
                        "text": name}
            except Exception as e:
                logger.warning("bad imagenet sample %s: %s", path, e)
        raise RuntimeError("too many consecutive bad samples")

    def __iter__(self):
        order = list(range(len(self.samples)))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in shard_for_process(order, *self.process):
            yield self[i]
