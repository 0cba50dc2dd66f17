"""Scans along long rows, each as a CUDA kernel and its plain PyTorch
version.

  - S1, the integer scans along the last dim: ``cumsum`` (inclusive
    prefix sum of bool, int32 or int64 rows, int64 out, as
    ``torch.cumsum`` promotes), ``cummax`` (running max) and
    ``rev_cummin`` (running min from the row's end: ``flip``, ``cummin``,
    ``flip``) of int32 or int64 rows. The JAX package's counterparts are
    ``jnp.cumsum`` in ``_run_segments``, ``_kth_impl`` and ``compact``
    (``fccf_pcr_tpu/ops/voxelize.py:116``, ``:208``, ``:386``),
    ``lax.cummax`` (``:526``), and the scans of ``features/faces.py`` and
    ``verify/fine.py``. Integer results are exact in any order of
    combination, so the kernel equals the plain version bit for bit.
  - S2, the float32 inclusive prefix sum along one dim in the association
    of XLA's cumsum on the CPU (the reference's goldens; ``jnp.cumsum`` at
    ``fccf_pcr_tpu/ops/voxelize.py:143``, ``:530`` and ``:584``): a
    base-16 blocked scan. Sequential sums from +0.0 inside rows of 16, the
    row totals scanned the same way one level up, and each level's
    exclusive total (+0.0 for the first row) added back with
    ``P + exc``; a scan of 2..16 entries is one such row, a scan of one
    entry returns it as it is. ``_prefix_sum0`` is the plain version.
    ``prefix_sum`` scans a tensor's columns; ``leaf_prefix_sums`` and
    ``moment_prefix_sums`` scan the voxelization's leaf and moment
    columns, which the kernel forms from their sources (the plain
    versions concatenate them first: ``leaf_columns`` /
    ``moment_columns``), so the columns are never written on the card.

CUDA tensors take the kernels of ``csrc/scan.cu`` on the current stream,
with no host sync, so the register step's CUDA graph captures them; there
is no fallback: a missing ``nvcc``, a failed build or a refused launch
raises. CPU tensors take the plain versions; any other device raises. The
library is built with nvcc into ``fccf_pcr_torch/build/`` at first use and
bound with ctypes (``ops.cuda_build``). ``INT_SCANS`` and ``PREFIX_SUMS``
count the calls that launch S1 (two kernels, one for rows of at most 1024
entries) and S2 (three kernels, one for columns of at most 256 entries;
``ops.graph.count_launch``: a launch captured into a CUDA graph counts at
each replay). Every entry point runs inside a ``record_function`` range
named ``scan.<entry>``.
"""

from __future__ import annotations

import ctypes
import math
import sys

import torch
from torch.profiler import record_function

from . import graph
from .cuda_build import CudaLibrary

# Calls that launched S1 (the integer scans) and S2 (the blocked prefix
# sum).
INT_SCANS = 0
PREFIX_SUMS = 0
_THIS = sys.modules[__name__]
# csrc/scan.cu's operations and input types.
SUM, MAX, MIN_REVERSED = 0, 1, 2
_IN_TYPES = {torch.bool: 0, torch.int32: 1, torch.int64: 2}


def _bind(lib):
    fn = lib.fccf_scan_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_scan_scratch_bytes
    fn.argtypes = [ctypes.c_longlong] * 2
    fn.restype = ctypes.c_longlong
    fn = lib.fccf_prefix_sum16_scratch
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    for name, pointers in (("fccf_prefix_sum16", 3),
                           ("fccf_prefix_sum16_leaf", 7),
                           ("fccf_prefix_sum16_moments", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_longlong] * (
            3 if name == "fccf_prefix_sum16" else 2) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("scan.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/scan.cu`` (if needed, or always with ``force``) and
    load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# ---------------------------------------------------------------- plain --


def int_scan_plain(x, op):
    """S1's plain version along the last dim: ``op`` SUM, MAX or
    MIN_REVERSED."""
    if op == SUM:
        return torch.cumsum(x, dim=-1)
    if op == MAX:
        return torch.cummax(x, dim=-1).values
    return torch.flip(torch.cummin(torch.flip(x, dims=[-1]), dim=-1).values,
                      dims=[-1])


def _prefix_sum0(x):
    """The blocked prefix sum along dim 0 (S2's plain version)."""
    m = x.shape[0]
    if m <= 16:
        cols = [x[0] if m == 1 else x[0] + 0.0]
        for c in range(1, m):
            cols.append(cols[-1] + x[c])
        return torch.stack(cols)
    rows = -(-m // 16)
    pad = x.new_zeros((rows * 16 - m,) + tuple(x.shape[1:]))
    X = torch.cat([x, pad]).reshape((rows, 16) + tuple(x.shape[1:]))
    cols = [X[:, 0] + 0.0]
    for c in range(1, 16):
        cols.append(cols[-1] + X[:, c])
    P = torch.stack(cols, dim=1)
    inc = _prefix_sum0(P[:, 15])
    exc = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    return (P + exc[:, None]).reshape((rows * 16,) + tuple(x.shape[1:]))[:m]


def prefix_sum_plain(x, dim=0):
    """S2's plain version along ``dim`` (any device)."""
    d = dim % x.dim()
    return _prefix_sum0(x.movedim(d, 0)).movedim(0, d)


def leaf_columns(px, py, pz, m_s, face_first):
    """The voxelization's leaf columns (..., n, 4) from the sorted anchored
    coordinates px, py, pz (float32) and flags m_s, face_first (bool), all
    (..., n): ``[px w, py w, pz w, ff]``, w = float(m_s) and ff =
    float(face_first & m_s) (a product by w, not a select)."""
    w = m_s.to(px.dtype)
    ff = (face_first & m_s).to(px.dtype)
    return torch.cat([torch.stack([px, py, pz], dim=-1) * w[..., None],
                      ff[..., None]], dim=-1)


def moment_columns(p, mask):
    """The voxelization's moment columns (..., n, 10) from p (..., n, 3)
    float32 and mask (..., n) bool: ``[x, y, z, xx, yy, zz, xy, xz, yz,
    float(mask)]``, the products in ``ops/voxelize.py::_outer6``'s order."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    outer6 = torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)
    return torch.cat([p, outer6, mask.to(p.dtype)[..., None]], dim=-1)


def leaf_sums_plain(px, py, pz, m_s, face_first):
    """``leaf_prefix_sums``' plain version (any device)."""
    return prefix_sum_plain(leaf_columns(px, py, pz, m_s, face_first), -2)


def moment_sums_plain(p, mask):
    """``moment_prefix_sums``' plain version (any device)."""
    return prefix_sum_plain(moment_columns(p, mask), -2)


# -------------------------------------------------------------- kernels --


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_int_scan(x, op):
    if x.dtype not in _IN_TYPES or (op != SUM and x.dtype == torch.bool):
        raise ValueError(f"int scan {op}: unsupported dtype {x.dtype}")
    n = x.shape[-1]
    out_dtype = torch.int64 if op == SUM else x.dtype
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    # Rows of n entries one row stride apart (a view where torch can give
    # one, such as a slice of each row's head).
    rows = x.reshape(-1, n)
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    lib = build()
    # A total a tile (none for rows of one tile).
    scratch = torch.empty(
        (int(lib.fccf_scan_scratch_bytes(rows.shape[0], n)),),
        dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):  # the C entry launches on it
        rc = lib.fccf_scan_int(rows.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), op, _IN_TYPES[x.dtype],
                               rows.shape[0], n, rows.stride(0),
                               _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"fccf_scan_int launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, "INT_SCANS")
    return out


def _prefix_sums(entry, sources, lead, n, D, dev):
    """One S2 call of C entry ``entry`` on ``sources`` (contiguous CUDA
    tensors) of B = prod(lead) batch rows of n entries and D columns:
    out (*lead, n, D) float32."""
    B = math.prod(lead)
    out = torch.empty(tuple(lead) + (n, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    scratch = torch.empty((B * D * int(lib.fccf_prefix_sum16_scratch(n)),),
                          dtype=torch.float32, device=dev)
    sizes = (B, n, D) if entry == "fccf_prefix_sum16" else (B, n)
    with torch.cuda.device(dev):  # the C entry launches on it
        rc = getattr(lib, entry)(*(t.data_ptr() for t in sources),
                                 out.data_ptr(), scratch.data_ptr(), *sizes,
                                 _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, "PREFIX_SUMS")
    return out


def _launch_prefix_sum(x3):
    """S2 on a contiguous (B, n, D) float32 CUDA tensor, along dim 1."""
    if x3.dtype != torch.float32:
        raise ValueError(f"prefix_sum kernel: want float32, got {x3.dtype}")
    B, n, D = x3.shape
    return _prefix_sums("fccf_prefix_sum16", (x3,), (B,), n, D, x3.device)


def _sources(what, floats, flags):
    """The sources of a fused S2 call, checked (float32 and bool tensors
    on one device) and made contiguous."""
    dev = floats[0].device
    for want, group in ((torch.float32, floats), (torch.bool, flags)):
        for t in group:
            if t.dtype != want or t.device != dev:
                raise ValueError(f"{what} kernel: want {want} on {dev}, got "
                                 f"{t.dtype} on {t.device}")
    return tuple(t.contiguous() for t in floats + flags)


def _launch_leaf_sums(px, py, pz, m_s, face_first):
    """S2 of ``leaf_columns`` formed in the kernel (CUDA tensors)."""
    shape = tuple(px.shape)
    if any(tuple(t.shape) != shape for t in (py, pz, m_s, face_first)):
        raise ValueError("leaf_prefix_sums: sources of different shapes")
    src = _sources("leaf_prefix_sums", (px, py, pz), (m_s, face_first))
    return _prefix_sums("fccf_prefix_sum16_leaf", src, shape[:-1],
                        shape[-1], 4, px.device)


def _launch_moment_sums(p, mask):
    """S2 of ``moment_columns`` formed in the kernel (CUDA tensors)."""
    if p.shape[-1] != 3 or tuple(p.shape[:-1]) != tuple(mask.shape):
        raise ValueError(f"moment_prefix_sums: p {tuple(p.shape)} and mask "
                         f"{tuple(mask.shape)} do not match")
    src = _sources("moment_prefix_sums", (p,), (mask,))
    return _prefix_sums("fccf_prefix_sum16_moments", src, mask.shape[:-1],
                        mask.shape[-1], 10, p.device)


def _int_scan(x, op):
    if x.device.type == "cpu":
        return int_scan_plain(x, op)
    if x.device.type == "cuda":
        return _launch_int_scan(x, op)
    raise ValueError(f"int scan: unsupported device {x.device}")


def cumsum(x):
    """Inclusive prefix sum along the last dim of a bool, int32 or int64
    tensor, int64 out (``torch.cumsum(x, dim=-1)``)."""
    with record_function("scan.cumsum"):
        return _int_scan(x, SUM)


def cummax(x):
    """Running max along the last dim of an int32 or int64 tensor
    (``torch.cummax(x, dim=-1).values``)."""
    with record_function("scan.cummax"):
        return _int_scan(x, MAX)


def rev_cummin(x):
    """Running min from the end of the last dim of an int32 or int64
    tensor: out[..., i] = min(x[..., i:])."""
    with record_function("scan.rev_cummin"):
        return _int_scan(x, MIN_REVERSED)


def prefix_sum(x, dim=0):
    """Inclusive prefix sum along ``dim`` in XLA's CPU association (see
    the module's docstring), so float32 prefixes agree bit for bit with
    the reference on every device and the error stays O(eps log16 N) of
    the prefix magnitude. The other dims are batch: each is scanned alone,
    with the same adds."""
    with record_function("scan.prefix_sum"):
        if x.device.type == "cpu":
            return prefix_sum_plain(x, dim)
        if x.device.type == "cuda":
            d = dim % x.dim()
            shape = tuple(x.shape)
            x3 = x.contiguous().view(math.prod(shape[:d]), shape[d],
                                     math.prod(shape[d + 1:]))
            return _launch_prefix_sum(x3).view(shape)
        raise ValueError(f"prefix_sum: unsupported device {x.device}")


def leaf_prefix_sums(px, py, pz, m_s, face_first):
    """``prefix_sum(leaf_columns(...), dim=-2)``: on a card S2 forms the
    four columns from their sources, so they are never written."""
    with record_function("scan.leaf_prefix_sums"):
        if px.device.type == "cpu":
            return leaf_sums_plain(px, py, pz, m_s, face_first)
        if px.device.type == "cuda":
            return _launch_leaf_sums(px, py, pz, m_s, face_first)
        raise ValueError(f"leaf_prefix_sums: unsupported device {px.device}")


def moment_prefix_sums(p, mask):
    """``prefix_sum(moment_columns(p, mask), dim=-2)``: on a card S2 forms
    the ten columns from p and mask, so they are never written."""
    with record_function("scan.moment_prefix_sums"):
        if p.device.type == "cpu":
            return moment_sums_plain(p, mask)
        if p.device.type == "cuda":
            return _launch_moment_sums(p, mask)
        raise ValueError(f"moment_prefix_sums: unsupported device {p.device}")
