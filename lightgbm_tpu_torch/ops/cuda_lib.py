"""Build and bind the hand-written Hopper kernels of ``csrc/``.

The CUDA sources are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``lightgbm_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. Each source compiles to its own object in a parallel ``nvcc``
process, then one link step makes the library; its file name carries a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is reused. Nothing here runs at import time.

The library is built with ``-fmad=false`` (no multiply-add contraction) and
without fast math: the kernels replay the reference's f32 arithmetic
operation by operation (see ``csrc/lgbt_common.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("grad_quant_hist0.cu", "hist_routed_fused.cu",
           "leaf_sums_grad.cu", "take_small.cu", "hist_q8.cu",
           "route_level.cu", "leaf_sums.cu", "hist_f32.cu",
           "hist_routed_fused_multi.cu", "split_search.cu")
HEADERS = ("lgbt_common.cuh", "slot_hist.cuh", "leaf_sums.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# the slot histograms' entries (csrc/slot_hist.cuh slot_hist_launch)
_SLOT_HIST = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              _I, _I, _P, _P, _I, _P, _P]
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
_SIGNATURES: Dict[str, List] = {
    "lgbt_grad_quant_hist0": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                              _I, _U, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _P],
    "lgbt_hist_routed_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                               _P, _I, _P, _P, _P],
    "lgbt_leaf_sums_grad": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                            _I, _P, _P, _P],
    "lgbt_take_small": [_P, _P, _I, _I, _P, _I, _P],
    "lgbt_hist_q8": _SLOT_HIST,
    "lgbt_route_level": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
                         _I, _P],
    "lgbt_leaf_sums": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "lgbt_hist_f32": _SLOT_HIST,
    "lgbt_hist_routed_fused_multi": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                     _I, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                                     _I, _I, _P, _P, _P, _I, _P, _P, _P],
    "lgbt_split_search": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                          _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed or is missing; the message carries the compiler output."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"   # the toolkit's standard prefix
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built from "
                           "lightgbm_tpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def _build(target: str) -> None:
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    t0 = time.perf_counter()
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs.append(obj)
    logs, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise KernelBuildError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = f"{target}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise KernelBuildError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
    os.replace(tmp, target)   # atomic: a reader never sees a partial library
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log="\n".join(logs),
                      built=True)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call if needed."""
    global _lib
    if _lib is not None:        # every launch comes here: no lock once loaded
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        target = os.path.join(BUILD_DIR, f"liblgbt_kernels_{_digest()}.so")
        BUILD_INFO.update(path=target, built=False, seconds=0.0, log="")
        if not os.path.exists(target):
            _build(target)
        lib = ctypes.CDLL(target)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # the seconds of this load, the build included when there was one
        BUILD_INFO["load_s"] = time.perf_counter() - t0
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
