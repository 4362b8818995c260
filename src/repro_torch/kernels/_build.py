"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each source under ``csrc/`` becomes a shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds, not minutes).  Libraries go to ``build/repro_torch_kernels/`` at the
repository root; the file name carries a hash of the source, the headers
it includes from ``csrc/`` (``#include "name.cuh"``) and the compiler
flags, so an edited source or header is never served by a stale library.

    lib = load("flash_attention").lib     # builds on the first call

``load`` is safe to call from several threads at once, one per library, so
that the sources compile side by side.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# flags a source adds to NVCC_FLAGS: the scan must replay the NumPy pass's
# float64 operations exactly, so nothing may be contracted into an FMA
EXTRA_FLAGS = {"sched_scan": ("-fmad=false",)}

# C signatures: name -> (restype, argtypes).
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "flash_attention": {
        "repro_flash_attention_fwd": (
            ctypes.c_int,
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.POINTER(ctypes.c_longlong), _F, _I, _P]),
        "repro_flash_attention_smem_bytes": (ctypes.c_int, [_I, _I]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "ssd_scan": {
        "repro_ssd_chunk_fwd": (
            ctypes.c_int,
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.POINTER(ctypes.c_longlong), _P]),
        "repro_ssd_chunk_fwd_smem_bytes": (ctypes.c_int, [_I]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "ssd_scan_bwd": {
        "repro_ssd_chunk_bwd": (
            ctypes.c_int,
            [_P] * 14 + [_I] * 7 + [ctypes.POINTER(ctypes.c_longlong), _P]),
        "repro_ssd_chunk_bwd_smem_bytes": (ctypes.c_int, [_I, _I, _I, _I]),
        "repro_ssd_chunk_bwd_parts": (ctypes.c_int, [_I, _I]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "sched_scan": {
        "repro_node_scan": (
            ctypes.c_int, [_P] * 9 + [_L, _L] + [_P] * 9 + [_I] * 6 + [_P]),
        "repro_sched_chase": (ctypes.c_int, [_I, _P, _I, _L, _P, _P]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "stream": {
        "repro_stream_elementwise": (
            ctypes.c_int, [_I, _I, _P, _P, _P, _P, _L, _P]),
        "repro_stream_triad": (
            ctypes.c_int, [_I, _P, _P, ctypes.c_double, _P, _L, _I, _P]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    name: str
    lib: ctypes.CDLL
    path: Path
    seconds: float     # nvcc wall time; 0.0 when the library was on disk
    log: str           # nvcc's output (ptxas register/shared-memory lines)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _local_headers(text: str) -> list[str]:
    """The ``csrc/`` headers that ``text`` includes, and theirs, in order."""
    seen: list[str] = []
    todo = _INCLUDE.findall(text)
    while todo:
        name = todo.pop(0)
        if name not in seen and (CSRC / name).is_file():
            seen.append(name)
            todo += _INCLUDE.findall((CSRC / name).read_text())
    return seen


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    h = hashlib.sha256(text)
    for header in _local_headers(text.decode()):
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(name: str) -> tuple[float, str]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file
    return seconds, log


@functools.lru_cache(maxsize=None)
def load(name: str) -> Built:
    """Build (if needed) and load kernel library ``name``; cached per process."""
    path = library_path(name)
    seconds, log = (0.0, "") if path.exists() else _compile(name)
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype, f.argtypes = restype, argtypes
    return Built(name, lib, path, seconds, log)
