"""Native host runtime loader.

Port of ``lightgbm_tpu/native/__init__.py``: ``fastio.cpp`` is compiled at
first use with g++ -O3, content-hashed into ``lightgbm_tpu_torch/_build/``
(listed in ``.gitignore``), and reached through ctypes: the CSV/TSV and
LibSVM parsers and the value->bin loop. When the build fails the parser
falls back to Python (``io/parser.py`` logs which parser ran); ``BUILD_INFO``
holds the build's outcome.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from .. import log

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
BUILD_INFO: dict = {}
_lib = None
_tried = False


def _build() -> Optional[str]:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"fastio_{digest}.so")
    if os.path.exists(so_path):
        BUILD_INFO.update(path=so_path, built=False)
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    err = None
    # -march=native: the value->bin linear scan relies on auto-
    # vectorization; retried without it for odd toolchains
    for extra in (["-march=native"], []):
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               *extra, _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
            BUILD_INFO.update(path=so_path, built=True)
            return so_path
        except Exception as e:   # toolchain missing or compile error
            err = e
    BUILD_INFO.update(path=None, error=str(err))
    log.warning(f"native fastio build FAILED ({err}); the text parser falls "
                "back to Python")
    return None


def get_lib():
    """The loaded native library, or None (the parser's Python path)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.csv_dims.restype = ctypes.c_int64
        lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_char,
                                 ctypes.POINTER(ctypes.c_int64)]
        lib.csv_parse.restype = ctypes.c_int32
        lib.csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_char, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.libsvm_scan.restype = ctypes.c_int64
        lib.libsvm_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.libsvm_fill.restype = ctypes.c_int32
        lib.libsvm_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_double)]
        lib.set_num_threads.restype = None
        lib.set_num_threads.argtypes = [ctypes.c_int]
        for name, ptr in (("bin_columns", ctypes.c_double),
                          ("bin_columns_f32", ctypes.c_float)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.POINTER(ptr), ctypes.c_int64,
                           ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_int64),
                           ctypes.POINTER(ctypes.c_int32),
                           ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    except Exception as e:
        BUILD_INFO.update(error=str(e))
        log.warning(f"native fastio load FAILED ({e}); the text parser "
                    "falls back to Python")
        _lib = None
    return _lib


def set_num_threads(n: int) -> None:
    """Cap the native worker threads (reference: num_threads, config.h:122,
    lightgbm_tpu/native/__init__.py:116-121)."""
    lib = get_lib()
    if lib is not None:
        lib.set_num_threads(int(n))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_delimited(raw: bytes, delim: str, skip_first: bool
                    ) -> Optional[np.ndarray]:
    """A CSV/TSV byte buffer as an [N, C] f64 matrix, or None without the
    native library (the caller parses in Python)."""
    lib = get_lib()
    if lib is None:
        return None
    ncols = ctypes.c_int64(0)
    nrows = lib.csv_dims(raw, len(raw), delim.encode()[0:1],
                         ctypes.byref(ncols))
    if skip_first:
        nrows -= 1
    if nrows <= 0 or ncols.value <= 0:
        return None
    out = np.empty((nrows, ncols.value), dtype=np.float64)
    bad = ctypes.c_int64(-1)
    rc = lib.csv_parse(raw, len(raw), delim.encode()[0:1], nrows, ncols.value,
                       1 if skip_first else 0, _dptr(out), ctypes.byref(bad))
    if rc != 0:
        log.fatal(f"native parser: row {bad.value} has the wrong column count")
    return out


def parse_libsvm(raw: bytes, num_features_hint: int = 0):
    """A LibSVM byte buffer as (X dense [N, F] f64, labels [N]), or None
    without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    approx_rows = raw.count(b"\n") + 1
    labels = np.empty(approx_rows, dtype=np.float64)
    nnz = np.empty(approx_rows, dtype=np.int64)
    mx = ctypes.c_int64(-1)
    n = lib.libsvm_scan(raw, len(raw), _dptr(labels),
                        nnz.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        approx_rows, ctypes.byref(mx))
    if n <= 0:
        return None
    nf = max(int(mx.value) + 1, num_features_hint)
    X = np.zeros((n, nf), dtype=np.float64)
    lib.libsvm_fill(raw, len(raw), n, nf, _dptr(X))
    return X, labels[:n].copy()


def bin_values(data: np.ndarray, bounds_list, na_bins) -> Optional[np.ndarray]:
    """Value->bin of every column of ``data`` [N, F] (f64 or f32) as uint8
    [N, F]: ``bounds_list[j]`` the ascending upper bounds of column j's
    non-NaN bins, ``na_bins[j]`` its NaN bin (the bin of 0.0 when the
    column has no NaN bin). None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    n, f = data.shape
    if data.dtype == np.float32:
        data = np.ascontiguousarray(data)
        entry, ptr = lib.bin_columns_f32, data.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))
    else:
        data = np.ascontiguousarray(data, dtype=np.float64)
        entry, ptr = lib.bin_columns, _dptr(data)
    off = np.zeros(f + 1, dtype=np.int64)
    for j, b in enumerate(bounds_list):
        off[j + 1] = off[j] + len(b)
    flat = (np.concatenate([np.asarray(b, np.float64) for b in bounds_list])
            if off[-1] else np.zeros(1))
    na = np.asarray(na_bins, dtype=np.int32)
    out = np.empty((n, f), dtype=np.uint8)
    entry(ptr, n, f, _dptr(flat),
          off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
          na.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out

