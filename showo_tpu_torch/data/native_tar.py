"""ctypes binding of the native tar-shard reader (``csrc/host/tario.cpp``).

Counterpart of ``showo_tpu/data/native_tar.py``: one pass of C++ over a
shard's headers makes its member table, and a sample's members are read
by parallel ``pread`` calls.  The library builds at first use
(``utils/host_build.py``); where it will not build or load, Python's
``tarfile`` indexes the shard and plain reads fetch the members.
``paths`` counts the shards indexed on each path ("native",
"tarfile"), and ``TarIndex.native`` says which one an index took.
"""

from __future__ import annotations

import collections
import ctypes
import logging
from typing import List

logger = logging.getLogger(__name__)

_lib = None
# shards indexed, by path: "native" | "tarfile"
paths: collections.Counter = collections.Counter()


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    try:
        from showo_tpu_torch.utils.host_build import load_host_library

        lib = load_host_library("tario")
        lib.tario_index.restype = ctypes.c_void_p
        lib.tario_index.argtypes = [ctypes.c_char_p]
        lib.tario_count.restype = ctypes.c_int64
        lib.tario_count.argtypes = [ctypes.c_void_p]
        lib.tario_name.restype = ctypes.c_char_p
        lib.tario_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_size.restype = ctypes.c_int64
        lib.tario_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_offset.restype = ctypes.c_int64
        lib.tario_offset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_free.argtypes = [ctypes.c_void_p]
        lib.tario_read.restype = ctypes.c_int64
        lib.tario_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        _lib = lib
    except (OSError, RuntimeError) as e:
        logger.warning("native tario unavailable (%s); using tarfile", e)
        _lib = False
    return _lib


class TarIndex:
    """The member table of one tar shard, native when the library loads."""

    def __init__(self, path: str):
        self.path = path
        lib = _load_lib()
        self.native = bool(lib)
        if self.native:
            self._lib = lib
            self._handle = lib.tario_index(path.encode())
            if not self._handle:
                raise IOError(f"tario_index failed for {path}")
            n = lib.tario_count(self._handle)
            self.names = [lib.tario_name(self._handle, i).decode()
                          for i in range(n)]
            self.sizes = [lib.tario_size(self._handle, i) for i in range(n)]
        else:
            import tarfile

            self._members: List = []
            with tarfile.open(path) as tf:
                for m in tf.getmembers():
                    if m.isfile():
                        self._members.append((m.name, m.offset_data, m.size))
            self.names = [m[0] for m in self._members]
            self.sizes = [m[2] for m in self._members]
        paths["native" if self.native else "tarfile"] += 1

    def __len__(self):
        return len(self.names)

    def read(self, indices: List[int], num_threads: int = 4) -> List[bytes]:
        """The members ``indices`` (parallel preads on the native path)."""
        if self.native:
            idx_arr = (ctypes.c_int64 * len(indices))(*indices)
            total = sum(self.sizes[i] for i in indices)
            out = ctypes.create_string_buffer(total)
            offs = (ctypes.c_int64 * len(indices))()
            got = self._lib.tario_read(self.path.encode(), self._handle,
                                       idx_arr, len(indices), out, total,
                                       offs, num_threads)
            if got < 0:
                raise IOError(f"tario_read failed for {self.path}")
            raw = out.raw
            return [raw[offs[i]:offs[i] + self.sizes[gi]]
                    for i, gi in enumerate(indices)]
        with open(self.path, "rb") as f:
            res = []
            for i in indices:
                f.seek(self._members[i][1])
                res.append(f.read(self._members[i][2]))
            return res

    def __del__(self):
        if getattr(self, "native", False) and getattr(self, "_handle", None):
            try:
                self._lib.tario_free(self._handle)
            except Exception:
                pass
