"""Build the host C++ sources of ``showo_tpu_torch/csrc/host`` (the data
readers' tar indexer and JPEG decoder) with ``g++`` into shared libraries.

A library goes into ``showo_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of its source and flags,
so an edited source is rebuilt and an unchanged one loaded as it is; a
build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library.  Nothing builds at
import time: the readers build at their first use, and fall back to
their Python paths when a build fails (no compiler, no ``-ljpeg``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


def library_path(name: str, libs: Sequence[str] = ()) -> tuple:
    """(source, library) paths of ``csrc/host/<name>.cpp``."""
    src = os.path.join(HOST_SRC, f"{name}.cpp")
    h = hashlib.sha256(" ".join(CXX_FLAGS + list(libs)).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_host_library(name: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/host/<name>.cpp`` once (``g++``, linked with ``libs``)
    and load it; raises when the compiler or a library is missing."""
    src, out = library_path(name, libs)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cxx = os.environ.get("CXX", "g++")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src,
                                   *libs], capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{cxx} failed on {src}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(out)
