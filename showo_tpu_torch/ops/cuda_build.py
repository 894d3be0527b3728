"""Build a CUDA source of ``showo_tpu_torch/csrc`` into a shared library
and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds.  The library goes into
``showo_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  The build writes to a temporary file
and renames it into place, so processes that build at once do not see a
half-written library.

Nothing here runs at import time: the first call of a kernel's wrapper
builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: dict = {}
# name -> {"seconds": build time (0.0 when loaded from _build), "log": nvcc output}
build_info: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of showo_tpu_torch are built from source at first use")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``; returns the ctypes handle."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        build_info[name] = {"seconds": 0.0, "log": "(cached build)"}
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        build_info[name] = {"seconds": seconds,
                            "log": (proc.stdout + proc.stderr).strip()}
    lib = ctypes.CDLL(out)
    _loaded[name] = lib
    return lib
