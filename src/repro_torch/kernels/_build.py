"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface, at first use, into a build directory that git
ignores (``build/kernels`` at the repo root, or ``$REPRO_TORCH_BUILD_DIR``).
The library's file name carries a hash of the source, so an edited source
builds anew and a stale library is never loaded. Libraries are loaded with
``ctypes``; nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

#: Target Hopper's full feature set; never --use_fast_math (the simulator's
#: results are bit-exact, and attention's exponential is the accurate expf).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: C signature of every entry point, by source: name -> argument types.
SIGNATURES = {
    "lod.cu": {
        "lod_pick": (_P, _P, _I, _I, _P),
        "lod_schedule_step": (_P, _P, _P, _P, _I, _I, _P),
        "lod_rotating_schedule_step": (_P, _P, _P, _P, _P, _I, _I, _P),
    },
    # mega_chunk(const MegaArgs* args, int eject, void* stream)
    "megakernel.cu": {
        "mega_chunk": (_P, _I, _P),
    },
    # anneal_rounds(const AnnealArgs* args, int ladders, void* stream);
    # anneal_guided_rounds(args, const GuideArgs* guide, ladders, stream)
    "anneal.cu": {
        "anneal_rounds": (_P, _I, _P),
        "anneal_guided_rounds": (_P, _P, _I, _P),
    },
    # flash_attention_fwd / _combine(const FlashArgs* args, void* stream);
    # flash_attention_ex2_error(s, mx, cols, n, scale, out, stream)
    "flash_attention.cu": {
        "flash_attention_fwd": (_P, _P),
        "flash_attention_combine": (_P, _P),
        "flash_attention_ex2_error": (_P, _P, _L, _L, ctypes.c_float, _P, _P),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
#: Compiler output (``ptxas -v`` register and spill counts) of each build.
build_logs: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:16]
    return build_dir() / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its hashed library already exists."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
        build_logs[source] = proc.stdout + proc.stderr
        os.replace(tmp, out)  # atomic: a concurrent build never sees a torso
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib
