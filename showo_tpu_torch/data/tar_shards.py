"""webdataset-style tar-shard pipeline (training/data.py).

Counterpart of ``showo_tpu/data/tar_shards.py``: the reference's
Text2ImageDataset flow (training/data.py:180-236) without webdataset:
brace-pattern shard expansion, an endless resampled shard stream, tar
members grouped by key, PIL decode, the external-caption joins, caption
cleanup, the image transform, and warn-and-continue on bad data, all on
the host, giving fixed-shape numpy samples.  The shards are read through
the native indexer (``data/native_tar.py``) or Python's ``tarfile``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import random
import re
import tarfile
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from showo_tpu_torch.utils.image import image_transform

logger = logging.getLogger(__name__)


def brace_expand(pattern: str) -> List[str]:
    """Expand ``{00000..00010}`` style ranges (a subset of braceexpand)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(brace_expand(pattern[:m.start()] + str(i).zfill(len(lo))
                                + pattern[m.end():]))
    return out


def iterate_tar_samples_native(path: str, num_threads: int = 4
                               ) -> Iterator[Dict[str, bytes]]:
    """:func:`iterate_tar_samples` over the native index: one C++ pass over
    the headers, then one batch of parallel preads a sample."""
    from showo_tpu_torch.data.native_tar import TarIndex

    try:
        idx = TarIndex(path)
    except Exception as e:
        logger.warning("native index failed for %s (%s); python fallback",
                       path, e)
        yield from iterate_tar_samples(path)
        return
    groups: Dict[str, list] = {}
    for i, name in enumerate(idx.names):
        key, _, ext = name.rpartition(".")
        groups.setdefault(key, []).append((ext.lower(), i))
    for key, members in groups.items():
        datas = idx.read([i for _, i in members], num_threads=num_threads)
        sample: Dict = {ext: d for (ext, _), d in zip(members, datas)}
        sample["__key__"] = key
        sample["__url__"] = path
        yield sample


def iterate_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """A shard's members grouped by basename key, in order:
    {ext: bytes, '__key__': key, '__url__': path}; a corrupt shard is
    skipped with a warning (training/data.py:90-95)."""
    try:
        with tarfile.open(path, "r|*") as tf:
            current_key = None
            sample: Dict = {}
            for member in tf:
                if not member.isfile():
                    continue
                key, _, ext = member.name.rpartition(".")
                if current_key is not None and key != current_key and sample:
                    sample["__key__"] = current_key
                    sample["__url__"] = path
                    yield sample
                    sample = {}
                current_key = key
                f = tf.extractfile(member)
                if f is not None:
                    sample[ext.lower()] = f.read()
            if sample:
                sample["__key__"] = current_key
                sample["__url__"] = path
                yield sample
    except Exception as e:
        logger.warning("skipping corrupt shard %s: %s", path, e)


REMOVE_PREFIXES = (
    "The image features ", "The image presents ", "The image you've sent is, ",
    "In the center of the image, ", "The image showcases ", "The image is ",
    "The image captures ", "In the given image ", "The image portrays ",
    "In the image, ", "In this image, we see ", "The image depicts ",
    "This is ", "In this image, ", "This image captures ",
    "This image showcases ", "This suggests ", "In the photo, we see ",
    "This image is ", "In the photo, we have ", "The photo features ",
    "The photo depicts ", "The photo appears to be ",
)


def remove_prefix(caption: str) -> str:
    """training/data.py:108-117's caption cleanup."""
    for p in REMOVE_PREFIXES:
        caption = caption.replace(p, "")
    return caption


# the reference reads ./training/questions.json (data.py:153), which its
# repository lacks; these are LLaVA-style caption prompts in its place
CAPTION_PROMPTS = (
    "Describe the image in detail.",
    "Provide a detailed description of the image.",
    "What is shown in the image?",
    "Write a descriptive caption for this image.",
    "Give a thorough account of what the image depicts.",
)


class ExternalCaptionJoin:
    """The reference's external caption tables (training/data.py:241-331):
    SA1B / laion / cc12m captions in side directories keyed by the shard
    url and the sample key, JourneyDB captions from one json map.  For
    generation a caption is its first sentence or all of it, 50 / 50
    (data.py:264-268), cleaned of its prefixes; for captioning it may get
    a random caption prompt in front.  Use as ``Text2ImageTarDataset(...,
    caption_fn=ExternalCaptionJoin(...), clean_caption=False)``."""

    def __init__(self, sa1b_caption_dir: Optional[str] = None,
                 laion_caption_dir: Optional[str] = None,
                 cc12m_caption_dir: Optional[str] = None,
                 journeydb_caption_json: Optional[str] = None,
                 is_captioning: bool = False,
                 add_caption_prompt: bool = False,
                 caption_prompts=CAPTION_PROMPTS, seed: int = 0):
        self.sa1b = sa1b_caption_dir
        self.laion = laion_caption_dir
        self.cc12m = cc12m_caption_dir
        self.is_captioning = is_captioning
        self.add_caption_prompt = add_caption_prompt
        self.caption_prompts = list(caption_prompts)
        self.rng = random.Random(seed)
        self.journeydb = None
        if journeydb_caption_json:
            with open(journeydb_caption_json) as f:
                self.journeydb = json.load(f)

    @staticmethod
    def _read(path: str) -> str:
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            lines = f.readlines()
        return lines[0].replace("\n", "") if lines else ""

    def _finish(self, captions: str) -> str:
        if self.is_captioning:
            if self.add_caption_prompt:
                prompt = self.rng.sample(self.caption_prompts, 1)[0]
                return prompt + " " + captions
            return captions
        if self.rng.random() < 0.5:
            captions = captions.split(".")[0]
        return remove_prefix(captions)

    def __call__(self, sample, url, key):
        url, key = url or "", key or ""
        default = sample.get("txt", b"")
        if isinstance(default, bytes):
            default = default.decode("utf-8", "replace")
        if self.sa1b and "SA1B" in key:
            return self._finish(
                self._read(f"{self.sa1b}/{key.split('/')[-1]}.txt"))
        if self.laion and "laion" in url:
            stem = url.split("/")[-1].split(".")[0]
            return self._finish(
                self._read(f"{self.laion}/{stem}/{key}.caption"))
        if self.cc12m and "cc12m" in url:
            stem = url.split("/")[-1].split(".")[0]
            return self._finish(self._read(
                f"{self.cc12m}/{stem}/{key.split('/')[-1]}.caption"))
        if self.journeydb is not None and key in self.journeydb:
            return self.rng.sample(self.journeydb[key], 1)[0]
        return default


class Text2ImageTarDataset:
    """Resampled tar shards -> {"image": [H, W, 3] float32, "text": str}.

    caption_fn(sample, url, key) -> str or None takes the external caption
    joins (:class:`ExternalCaptionJoin`); by default the caption is the
    sample's .txt, or the caption / text of its .json.  Each process reads
    its own shards (``data/loader.py::shard_for_process``; ``process``:
    (index, count) of this process, ``process_rank`` by default)."""

    def __init__(self, shard_pattern: str, resolution: int = 256,
                 shuffle_buffer: int = 1000, seed: int = 0,
                 caption_fn: Optional[Callable] = None,
                 clean_caption: bool = True, resample: bool = True,
                 shard_for_host: bool = True, use_native: bool = True,
                 process: Optional[Tuple[int, int]] = None):
        self.shards = brace_expand(shard_pattern)
        if shard_for_host:
            from showo_tpu_torch.data.loader import shard_for_process

            self.shards = shard_for_process(
                self.shards, *(process or (None, None))) or self.shards
        self.resolution = resolution
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.caption_fn = caption_fn
        self.clean_caption = clean_caption
        self.resample = resample
        self.use_native = use_native

    def _shard_stream(self) -> Iterator[str]:
        rng = np.random.default_rng(self.seed)
        if self.resample:   # with replacement (webdataset ResampledShards)
            while True:
                yield self.shards[int(rng.integers(0, len(self.shards)))]
        else:
            yield from self.shards

    def _decode(self, sample: Dict):
        from PIL import Image

        img_bytes = next((sample[e] for e in ("jpg", "jpeg", "png", "webp")
                          if e in sample), None)
        if img_bytes is None:
            return None
        try:
            img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
        except Exception as e:
            logger.warning("bad image in %s/%s: %s", sample.get("__url__"),
                           sample.get("__key__"), e)
            return None
        if self.caption_fn is not None:
            text = self.caption_fn(sample, sample.get("__url__"),
                                   sample.get("__key__"))
        elif "txt" in sample:
            text = sample["txt"].decode("utf-8", "replace")
        elif "json" in sample:
            meta = json.loads(sample["json"])
            text = meta.get("caption") or meta.get("text") or ""
        else:
            text = ""
        if text is None:
            return None
        if self.clean_caption:
            text = remove_prefix(text)
        return {"image": image_transform(img, self.resolution), "text": text}

    def __iter__(self):
        from showo_tpu_torch.data.loader import ShuffleBuffer

        reader = (iterate_tar_samples_native if self.use_native
                  else iterate_tar_samples)

        def raw():
            for shard in self._shard_stream():
                for s in reader(shard):
                    decoded = self._decode(s)
                    if decoded is not None:
                        yield decoded

        if self.shuffle_buffer > 1:
            yield from ShuffleBuffer(raw(), self.shuffle_buffer, self.seed)
        else:
            yield from raw()
