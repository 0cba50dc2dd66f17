"""Fine verify's per-candidate join: its kernels and their plain PyTorch
versions (port of ``fccf_pcr_tpu/verify/fine.py:138`` ``fine_verify``: the
join sort at ``:193-194``, the run ends' ``cummin`` at ``:202`` and the sum
at ``:216``).

A pair's table (``verify.fine.build_source_table``) holds its cloud's
sorted unique voxel keys in its R occupied slots, then the sentinel, and
each key's point count. In the sorted join [table keys ++ a candidate's
keys] only the runs that begin with a table entry and hold keys of the
candidate score, and the run of occupied slot i starts at place
``i + sum(hit[:i] + below[:i]) + below[i]``, where ``hit[i]`` counts the
candidate's keys equal to key i and ``below[i]`` those between keys i - 1
and i. So a candidate's join is a lookup and two counts a slot:

  - V1, ``lookup``: each (candidate, target point)'s key as ``fine.keys``
    forms it (``candidate_keys``: the transform, the cell, the window test,
    the packing), its place in the table, and one count: ``hit`` where it
    equals the key there, else ``below``. A key past the last occupied
    slot is counted nowhere.
  - V2, ``score``: each slot's place in the join, the value (s + t) *
    min(s, t) / max(max(s, t), 1) of each live slot (t = hit >= 1, s its
    count), ``ops.batch.fold_sum`` over the join's Vf + M places with +0.0
    at the others, and the score similar / max(n_src + sum(tar_mask), 1).

CUDA tensors take the kernels of ``csrc/fine.cu`` on the current stream,
with no host sync, so the register step's CUDA graph captures them; there
is no fallback: a missing ``nvcc``, a failed build or a refused launch
raises. CPU tensors take the plain versions (``lookup_plain``,
``score_plain``): the join sort's float operations in its order, so the
CPU's bits are those of the port's join sort before the kernels. Any other
device raises. Each kernel gives its plain version's bits on the card. The
library is built with nvcc into ``fccf_pcr_torch/build/`` at first use and
bound with ctypes (``ops.cuda_build``). ``LOOKUPS`` and ``SCORES`` count
the launches of V1 and V2 (``ops.graph.count_launch``: a launch captured
into a CUDA graph counts at each replay). Every entry point runs inside a
``record_function`` range named ``fine_kernels.<entry>``.

The table is read by field (``keys``, ``counts``, ``n_src``, ``cell_min``,
``cell_max``). Leading batch dims (a pair axis) go first: T is (..., C, 4,
4), the target cloud (..., M, 3) and its mask (..., M), each pair scored
against its own table; hit and below are (..., C, Vf) int32.
"""

from __future__ import annotations

import ctypes
import math
import sys

import torch
from torch.profiler import record_function

from .batch import fold_sum, scatter_unique, small_matmul, take
from .cuda_build import CudaLibrary
from .launch import checked, device_type, launched, stream
from .voxelize import _inv, cell_index

# Keys are 30-bit packed cells in int64 (the JAX package's uint32 order);
# the all-ones uint32 sentinel sorts after every key.
SENTINEL = 0xFFFFFFFF

# Launches of V1 and V2.
LOOKUPS = 0
SCORES = 0
_THIS = sys.modules[__name__]


def _bind(lib):
    fn = lib.fccf_fine_lookup
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_fine_score
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_fine_row_floats
    fn.argtypes = []
    fn.restype = ctypes.c_longlong


_LIBRARY = CudaLibrary("fine.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/fine.cu`` (if needed, or always with ``force``) and
    load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# ---------------------------------------------------------------- plain --


def pack_cells(cells, mask):
    """10 bits a cell axis with wraparound, x highest (30 bits), int64;
    the sentinel where ``mask`` is False."""
    kx = (cells[..., 0] & 1023).to(torch.int64)
    ky = (cells[..., 1] & 1023).to(torch.int64)
    kz = (cells[..., 2] & 1023).to(torch.int64)
    key = (kx << 20) | (ky << 10) | kz
    return torch.where(mask, key, SENTINEL)


def candidate_keys(T, table, tar_pts, tar_mask, params):
    """Each candidate's keys of the target cloud, (..., C, M) int64: the
    cells of the transformed points, the sentinel where a point is masked
    or its cell lies outside the table's window (``fine.keys``)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tar_t = small_matmul(tar_pts[..., None, :, :], R.mT) + t[..., None, :]
    cells_t = cell_index(tar_t, params.fine_voxel)
    in_win = torch.all(
        (cells_t >= table.cell_min[..., None, None, :])
        & (cells_t <= table.cell_max[..., None, None, :]), dim=-1
    )
    return pack_cells(cells_t, tar_mask[..., None, :] & in_win)


def lookup_plain(T, table, tar_pts, tar_mask, params):
    """V1's plain version: (hit, below), (..., C, Vf) int32, each key of
    ``candidate_keys`` counted at its place in the table
    (``torch.searchsorted``), integer counts."""
    with record_function("fine.keys"):
        keys_t = candidate_keys(T, table, tar_pts, tar_mask, params)
    with record_function("fine.join"):
        lead = tuple(tar_mask.shape[:-1])
        C, M = keys_t.shape[-2:]
        Vf = table.keys.shape[-1]
        flat = keys_t.reshape(lead + (C * M,))
        idx = torch.searchsorted(table.keys, flat)
        at = take(table.keys, torch.clamp(idx, max=Vf - 1))
        counted = (flat != SENTINEL) & (idx < Vf) & (at != SENTINEL)
        # One row of 2 x C x (Vf + 1) counters a pair: [hit, below] x
        # candidate x (slot, a dump slot for the keys counted nowhere).
        cand = torch.arange(C, device=flat.device)[:, None].expand(C, M)
        kind = torch.where(at == flat, 0, 1)
        dest = ((kind * C + cand.reshape(C * M)) * (Vf + 1)
                + torch.where(counted, idx, Vf))
        counts = torch.zeros(lead + (2 * C * (Vf + 1),), dtype=torch.int32,
                             device=flat.device)
        counts.scatter_add_(-1, dest, torch.ones_like(dest,
                                                      dtype=torch.int32))
        counts = counts.view(lead + (2, C, Vf + 1))[..., :Vf]
        return counts[..., 0, :, :], counts[..., 1, :, :]


def score_plain(hit, below, table, tar_mask):
    """V2's plain version: each candidate's score, (..., C) float32."""
    with record_function("fine.score"):
        Vf = hit.shape[-1]
        n = Vf + tar_mask.shape[-1]
        slot = torch.arange(Vf, device=hit.device)
        place = slot + torch.cumsum(hit + below, dim=-1) - hit
        s_cnt = table.counts[..., None, :]
        # The run's length less its table entry.
        t_cnt = (hit + 1).to(torch.float32) - 1.0
        live = t_cnt >= 1.0
        mn = torch.minimum(s_cnt, t_cnt)
        mx = torch.maximum(s_cnt, t_cnt)
        # fold_sum: a library's long reduction splits its work by the number
        # of outputs, so its rounding would depend on the batch.
        similar = fold_sum(scatter_unique(
            n, torch.where(live, place, n),
            (s_cnt + t_cnt) * mn / torch.clamp(mx, min=1.0)), dim=-1)
        total = table.n_src + torch.sum(tar_mask.to(torch.float32), dim=-1)
        return similar / torch.clamp(total, min=1.0)[..., None]


# -------------------------------------------------------------- kernels --


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _launch_lookup(T, table, tar_pts, tar_mask, params):
    """V1 on CUDA tensors."""
    lead, M = tuple(tar_mask.shape[:-1]), tar_mask.shape[-1]
    C, Vf = T.shape[-3], table.keys.shape[-1]
    P = math.prod(lead)
    ins = checked(
        ("T", "tar_pts", "tar_mask", "table.keys", "table.cell_min",
         "table.cell_max"),
        (T, tar_pts, tar_mask, table.keys, table.cell_min, table.cell_max),
        (torch.float32, torch.float32, torch.bool, torch.int64, torch.int32,
         torch.int32),
        (lead + (C, 4, 4), lead + (M, 3), lead + (M,), lead + (Vf,),
         lead + (3,), lead + (3,)))
    if P > 65535 or Vf < 1:
        raise ValueError(f"lookup: {P} pairs of a {Vf}-slot table, want at "
                         "most 65535 pairs and a slot")
    counts = torch.zeros((2,) + lead + (C, Vf), dtype=torch.int32,
                         device=T.device)
    if counts.numel() == 0 or M == 0:
        return counts[0], counts[1]
    lib = build()
    with torch.cuda.device(T.device):  # the C entry launches on it
        rc = lib.fccf_fine_lookup(
            *_ptrs(ins + (counts[0], counts[1])), P, C, M, Vf,
            _inv(params.fine_voxel), stream(T.device))
    launched(rc, "fccf_fine_lookup", _THIS, "LOOKUPS")
    return counts[0], counts[1]


def _launch_score(hit, below, table, tar_mask):
    """V2 on CUDA tensors."""
    lead, M = tuple(tar_mask.shape[:-1]), tar_mask.shape[-1]
    C, Vf = hit.shape[-2:]
    P = math.prod(lead)
    ins = checked(
        ("hit", "below", "table.counts", "table.n_src", "tar_mask"),
        (hit, below, table.counts, table.n_src, tar_mask),
        (torch.int32, torch.int32, torch.float32, torch.float32, torch.bool),
        (lead + (C, Vf), lead + (C, Vf), lead + (Vf,), lead, lead + (M,)))
    # The mask's count is exact as a float32 sum below 2^24.
    if P > 65535 or C > 65535 or Vf < 1 or M >= 2**24:
        raise ValueError(f"score: {P} pairs of {C} candidates, {Vf} slots "
                         f"and {M} points, want at most 65535 pairs and "
                         "candidates, a slot and fewer than 2^24 points")
    dev = hit.device
    out = torch.empty(lead + (C,), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    width = (Vf + M + 1) // 2
    scratch = (torch.empty((P, C, width), dtype=torch.float32, device=dev)
               if width > lib.fccf_fine_row_floats() else None)
    with torch.cuda.device(dev):
        rc = lib.fccf_fine_score(
            *_ptrs(ins + (out,)), None if scratch is None else
            scratch.data_ptr(), P, C, M, Vf, stream(dev))
    launched(rc, "fccf_fine_score", _THIS, "SCORES")
    return out


# -------------------------------------------------------------- entries --


def lookup(T, table, tar_pts, tar_mask, params):
    """(hit, below) of each candidate's keys in its pair's table
    (``lookup_plain``): V1 on a card."""
    with record_function("fine_kernels.lookup"):
        if device_type(T, "lookup") == "cpu":
            return lookup_plain(T, table, tar_pts, tar_mask, params)
        return _launch_lookup(T, table, tar_pts, tar_mask, params)


def score(hit, below, table, tar_mask):
    """Each candidate's fine score from its counts (``score_plain``): V2
    on a card."""
    with record_function("fine_kernels.score"):
        if device_type(hit, "score") == "cpu":
            return score_plain(hit, below, table, tar_mask)
        return _launch_score(hit, below, table, tar_mask)
