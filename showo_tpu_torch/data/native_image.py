"""ctypes binding of the native JPEG batch decoder
(``csrc/host/imgdec.cpp``).

Counterpart of ``showo_tpu/data/native_image.py``: ``decode_batch(buffers,
resolution)`` decodes JPEG byte strings in a C++ thread pool into one
[N, res, res, 3] float32 array in [-1, 1]; what the native path cannot
decode (PNG, WebP, a corrupt file) goes through PIL and the bicubic
``image_transform``, as does every image when the library will not build
(no ``-ljpeg``).  The native resize is bilinear: a throughput path for
training data.  ``paths`` counts the images decoded on each path
("native", "pil").
"""

from __future__ import annotations

import collections
import ctypes
import io
import logging
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_lib = None
# images decoded, by path: "native" | "pil"
paths: collections.Counter = collections.Counter()


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    try:
        from showo_tpu_torch.utils.host_build import load_host_library

        lib = load_host_library("imgdec", libs=("-ljpeg",))
        lib.imgdec_batch.restype = ctypes.c_int64
        lib.imgdec_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int]
        _lib = lib
    except (OSError, RuntimeError) as e:
        logger.warning("native imgdec unavailable (%s); PIL only", e)
        _lib = False
    return _lib


def _pil_decode(buf: bytes, resolution: int) -> Optional[np.ndarray]:
    from PIL import Image

    from showo_tpu_torch.utils.image import image_transform

    try:
        return image_transform(Image.open(io.BytesIO(buf)).convert("RGB"),
                               resolution)
    except Exception:
        return None


def decode_batch(buffers: List[bytes], resolution: int,
                 num_threads: int = 4) -> Tuple[np.ndarray, List[bool]]:
    """([N, res, res, 3] float32 in [-1, 1], whether each decoded)."""
    n = len(buffers)
    out = np.zeros((n, resolution, resolution, 3), np.float32)
    valid = [False] * n
    lib = _load_lib()
    todo = list(range(n))
    if lib and n:
        bufs = (ctypes.c_char_p * n)(*buffers)
        lens = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
        ok = (ctypes.c_uint8 * n)()
        lib.imgdec_batch(bufs, lens, n, resolution,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         ok, num_threads)
        todo = [i for i in range(n) if not ok[i]]
        for i in range(n):
            valid[i] = bool(ok[i])
        paths["native"] += n - len(todo)
    for i in todo:
        dec = _pil_decode(buffers[i], resolution)
        if dec is not None:
            out[i] = dec
            valid[i] = True
            paths["pil"] += 1
    return out, valid
