"""ctypes bindings for the native C++ runtime (csrc/).

Loads ``libfccf_io.so`` (built by ``make -C csrc``) and exposes the fast
PLY reader. All entry points degrade gracefully to ``None`` when the
library isn't built, letting pure-Python fallbacks take over.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path():
    # installed (site-packages) layouts have no csrc/ sibling; FCCF_IO_LIB
    # points at the built library explicitly there
    env = os.environ.get("FCCF_IO_LIB")
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "csrc", "build", "libfccf_io.so")


def load_library():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.fccf_ply_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fccf_ply_read.restype = ctypes.c_int
        lib.fccf_ply_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.fccf_ply_free.restype = None
        lib.fccf_ply_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fccf_ply_read_batch.restype = ctypes.c_int
        if hasattr(lib, "fccf_pcd_read"):
            lib.fccf_pcd_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.fccf_pcd_read.restype = ctypes.c_int
            lib.fccf_pcd_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.fccf_pcd_free.restype = None
        _LIB = lib
    except (OSError, AttributeError):
        # AttributeError: a stale library (e.g. FCCF_IO_LIB pointing at a
        # pre-batch-API build) missing a symbol must degrade to the
        # Python fallback like any other load failure, per the module
        # contract — not crash every reader.
        _LIB = None
    return _LIB


def native_read_ply(path: str):
    """Read a PLY with the native parser. Returns (N,3) float32 or None if
    the library is unavailable or the file needs the Python fallback."""
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.fccf_ply_read(path.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc == 1:
        raise FileNotFoundError(path)
    if rc != 0:
        return None  # unsupported layout -> python fallback
    try:
        buf = np.ctypeslib.as_array(out, shape=(n.value, 3))
        return np.array(buf, dtype=np.float32)  # owning copy
    finally:
        lib.fccf_ply_free(out)


def native_read_pcd(path: str):
    """Read a PCD with the native parser (ascii/binary/binary_compressed,
    C LZF decoder). Returns (N,3) float32 or None if the library is
    unavailable or the layout needs the Python fallback."""
    lib = load_library()
    if lib is None or not hasattr(lib, "fccf_pcd_read"):
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.fccf_pcd_read(path.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc == 1:
        raise FileNotFoundError(path)
    if rc != 0:
        return None  # unsupported layout -> python fallback
    try:
        buf = np.ctypeslib.as_array(out, shape=(n.value, 3))
        return np.array(buf, dtype=np.float32)  # owning copy
    finally:
        lib.fccf_pcd_free(out)


def native_read_ply_batch(paths, capacity: int, threads: int = 8):
    """Threaded batch load of PLY files, padded/subsampled into the
    pipeline's fixed-capacity layout.

    Returns (points (n, capacity, 3) float32, mask (n, capacity) bool,
    raw_counts (n,) int64) or None when the native library is unavailable
    (callers fall back to read_ply + pad_points per file)."""
    lib = load_library()
    if lib is None:
        return None
    n = len(paths)
    pts = np.zeros((n, capacity, 3), np.float32)
    mask = np.zeros((n, capacity), np.uint8)
    counts = np.zeros((n,), np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.fccf_ply_read_batch(
        arr,
        n,
        capacity,
        threads,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == 1:
        raise FileNotFoundError("one or more PLY files could not be opened")
    if rc != 0:
        return None  # unsupported layout somewhere -> python fallback
    return pts, mask.astype(bool), counts
