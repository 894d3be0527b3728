"""Build the CUDA sources of ``showo_tpu_torch/csrc`` into shared libraries,
load them with ctypes, and count kernel launches.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds; the ``*.cuh`` headers beside them hold
device code that several sources share.  A library goes into
``showo_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of its source, every header and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.  A
build writes to a temporary file and renames it into place, so processes
that build at once do not see a half-written library.
:func:`load_libraries` starts one ``nvcc`` per missing library, all at
once.

Nothing here runs at import time: the first call of a kernel's wrapper
builds it.  ``launches[name]`` counts the launches of the kernel of
``csrc/<name>.cu``, or of one named kernel where a source holds several;
only :func:`launch` adds to it, right after a launch went through
(:func:`count_launch`).
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: dict = {}
_entries: dict = {}
# name -> {"seconds": build time (0.0 when loaded from _build), "log": nvcc output}
build_info: dict = {}
# name -> number of launches of that library's kernel
launches: collections.Counter = collections.Counter()


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


def _library_path(name: str) -> tuple:
    """(source, library) paths of ``csrc/<name>.cu``."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_libraries(names) -> list:
    """Build (once) and load ``csrc/<name>.cu`` for each name; the missing
    libraries build in parallel.  Returns the ctypes handles in order."""
    todo = {}
    for name in names:
        if name in _loaded or name in todo:
            continue
        src, out = _library_path(name)
        if os.path.exists(out):
            build_info[name] = {"seconds": 0.0, "log": "(cached build)"}
            todo[name] = (out, None)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src]
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo[name] = (out, (proc, cmd, tmp, time.perf_counter()))
    failed = []
    for name, (out, job) in todo.items():
        if job is None:
            continue
        proc, cmd, tmp, t0 = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build csrc/{name}.cu (exit "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "log": log.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, (out, _) in todo.items():
        _loaded[name] = ctypes.CDLL(out)
    return [_loaded[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``; returns the ctypes handle."""
    return load_libraries([name])[0]


def _entry(name: str, symbol: str, argtypes):
    """The ctypes function of C entry ``symbol`` of ``csrc/<name>.cu``,
    bound once (``argtypes`` plus the stream)."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check_plain(kernel: str, *tensors) -> None:
    """Raise TypeError when a DTensor reaches a kernel's wrapper: the
    kernels and their plain versions take plain tensors (a model sharded
    by ``parallel/mesh.py`` gathers each weight whole before it is used,
    and its activations are plain)."""
    for t in tensors:
        if type(t).__name__ == "DTensor":
            raise TypeError(f"{kernel}: a DTensor reached the kernel's "
                            f"wrapper; it takes plain tensors")


def launch(name: str, symbol: str, argtypes, device, *args,
           kernel=None) -> None:
    """Call the C entry ``symbol`` of ``csrc/<name>.cu`` (built at first
    use) with ``args`` and the current stream of ``device`` appended, on
    that device.  Every entry returns the cudaError_t of its launch: a
    refused launch raises, one that went through is counted in
    ``launches[kernel]`` (``kernel`` names one of several kernels of a
    source, or is a tuple of counter names that each count it; by default
    the count is the source's, ``launches[name]``).
    The decode step calls this ~50 times a token, so the device switch is
    made only when the tensors are not on the current device."""
    fn = _entry(name, symbol, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    count_launch(kernel or name, err)


def count_launch(name, err: int) -> None:
    """Raise on a launch that returned cudaError ``err`` != 0; count one
    that went through (``name``: a counter name or a tuple of them)."""
    names = (name,) if isinstance(name, str) else name
    if err != 0:
        raise RuntimeError(f"{names[-1]} kernel launch failed: cudaError "
                           f"{err}")
    for n in names:
        launches[n] += 1
