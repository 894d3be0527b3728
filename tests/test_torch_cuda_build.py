"""The kernel build and launch bookkeeping of showo_tpu_torch
(``ops/cuda_build.py``), on the CPU: which sources a library's name
covers, the launch counters, and the refusals that need no card."""

import os
import sys

import pytest
import torch

from showo_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A scratch csrc/ with one source and one shared header."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    return tmp_path


def test_library_name_covers_source_and_headers(csrc):
    """An edit to the source or to any header names a new library, so a
    stale build is never loaded; an unchanged tree names the same one."""
    _, first = cuda_build._library_path("k")
    assert cuda_build._library_path("k")[1] == first
    (csrc / "shared.cuh").write_text("// v2\n")
    _, second = cuda_build._library_path("k")
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    _, third = cuda_build._library_path("k")
    assert len({first, second, third}) == 3


def test_build_without_nvcc_raises(csrc, tmp_path, monkeypatch):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_library("k")
    assert "k" not in cuda_build._loaded


def test_launch_is_counted_only_when_it_went_through(monkeypatch):
    monkeypatch.setattr(cuda_build, "launches", type(cuda_build.launches)())
    cuda_build.count_launch("k", 0)
    cuda_build.count_launch("k", 0)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        cuda_build.count_launch("k", 9)     # cudaErrorInvalidConfiguration
    assert cuda_build.launches == {"k": 2}


def test_launch_counts_every_named_counter(monkeypatch):
    """A launch named by a tuple (a source and one of its cores) counts
    once in each counter, and a refused one in none."""
    monkeypatch.setattr(cuda_build, "launches", type(cuda_build.launches)())
    cuda_build.count_launch(("src", "src_core"), 0)
    with pytest.raises(RuntimeError, match="src_core kernel launch failed"):
        cuda_build.count_launch(("src", "src_core"), 1)
    assert cuda_build.launches == {"src": 1, "src_core": 1}


def test_gpu_entry_points_refuse_to_run_without_a_card():
    """chip_smoke.py exits 2 and the profiler raises, with no result,
    when torch sees no CUDA card (as on the CPU test machines)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from showo_tpu_torch import profile_t2i

    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_t2i.main(["--route", "fused"])
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main() == 2


def _c_entries():
    """{symbol: [ctypes type of each parameter]} of every ``extern "C"``
    entry of csrc/*.cu, read from the sources (no compiler here)."""
    import ctypes
    import glob
    import re

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    out = {}
    for path in glob.glob(os.path.join(cuda_build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = []
            for p in params.split(","):
                p = " ".join(p.split()[:-1]).replace("const ", "")
                types.append(ctypes.c_void_p if p.endswith("*")
                             else kinds[p])
            out[name] = types
    return out


def test_entries_take_what_their_wrappers_pass():
    """Each C entry that the decode gemv, kernel 6 and kernel 1 launch
    takes the ctypes types its wrapper binds, in order, and the stream
    last: a wrong count or type would pass garbage on the card."""
    import ctypes

    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import int8_matmul as ti8

    entries = _c_entries()
    bound = {f"{src}_{core}_bf16": args
             for src in ("int8_matmul", "int4_matmul")
             for core, args in (("gemv", ti8._GEMV_ARGS),
                                ("mma", ti8._MMA_ARGS),
                                ("prefill", ti8._PF_ARGS))}
    bound.update({"omni_attention_packed_bf16": tfa._PACKED_ARGS,
                  "omni_attention_gqa_stacked_bf16": tfa._STACKED_ARGS,
                  "omni_attention_gqa_stacked_tiles": tfa._TILES_ARGS,
                  "omni_attention_packed_tiles": tfa._TILES_ARGS})
    for name, args in bound.items():
        assert entries[name] == list(args) + [ctypes.c_void_p], name


def test_first_tile_core_holds_no_kernel():
    """attention_tile.cuh keeps the pieces the wgmma cores share; every
    attention kernel runs on the wgmma cores."""
    with open(os.path.join(cuda_build.CSRC, "attention_tile.cuh")) as f:
        assert "__global__" not in f.read()
