"""Fine verify's per-candidate join: its kernel and its plain PyTorch
version (port of ``fccf_pcr_tpu/verify/fine.py:138`` ``fine_verify``: the
keys at ``:168-177``, the join sort at ``:193-194``, the run ends'
``cummin`` at ``:202`` and the sum at ``:216``).

A pair's table (``verify.fine.build_source_table``) holds its cloud's
sorted unique voxel keys in its R occupied slots, then the sentinel, and
each key's point count. In the sorted join [table keys ++ a candidate's
keys] only the runs that begin with a table entry and hold keys of the
candidate score, and the run of occupied slot i starts at place
``i + sum(hit[:i] + below[:i]) + below[i]``, where ``hit[i]`` counts the
candidate's keys equal to key i and ``below[i]`` those between keys i - 1
and i. So a candidate's join is a lookup and two counts a slot, then a
score:

  - ``lookup_plain``: each (candidate, target point)'s key as
    ``fine.keys`` forms it (``candidate_keys``: the transform, the cell,
    the window test, the packing), its place in the table, and one count:
    ``hit`` where it equals the key there, else ``below``. A key past the
    last occupied slot is counted nowhere.
  - ``score_plain``: each slot's place in the join, the value (s + t) *
    min(s, t) / max(max(s, t), 1) of each live slot (t = hit >= 1, s its
    count), ``ops.batch.fold_sum`` over the join's Vf + M places with +0.0
    at the others, and the score similar / max(n_src + sum(tar_mask), 1).

``join`` is the two: on CUDA tensors one launch of the kernel of
``csrc/fine.cu`` (a cluster of blocks a candidate, the counts in shared
memory; where no cluster holds a candidate's share there, clusters of 8
blocks a candidate with its share in a scratch the wrapper allocates) on the current
stream, with no host sync, so the register step's CUDA graph captures it; there is no
fallback: a missing ``nvcc``, a failed build, a refused launch or a shape
the kernel does not take (2^31 places or more, 2^24 points or more)
raises. CPU tensors take ``join_plain``,
``score_plain(*lookup_plain(...))``: the join sort's float operations in
its order, so the CPU's bits are those of the port's join sort. Any other
device raises. The kernel gives its plain version's bits on the card.
The library is built with nvcc into ``fccf_pcr_torch/build/`` at first use
and bound with ctypes (``ops.cuda_build``). ``JOINS`` counts the launches
(``ops.graph.count_launch``: a launch captured into a CUDA graph counts at
each replay). ``join`` runs inside a ``record_function`` range named
``fine_kernels.join``.

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

# Launches of the join.
JOINS = 0
_THIS = sys.modules[__name__]
# The cluster sizes the kernel takes, in the order it is offered them; 0
# (no cluster holds the share) takes the scratch.
CLUSTERS = (1, 2, 4, 8)


def _bind(lib):
    fn = lib.fccf_fine_join
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_fine_join_shared
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    fn = lib.fccf_fine_join_scratch
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
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


def join_plain(T, table, tar_pts, tar_mask, params):
    """The join's plain version: each candidate's score, (..., C)
    float32."""
    return score_plain(*lookup_plain(T, table, tar_pts, tar_mask, params),
                       table, tar_mask)


# -------------------------------------------------------------- kernels --


def cluster_size(lib, Vf, M):
    """The least cluster size whose blocks hold a candidate's share of a
    Vf-slot table and M points in shared memory; 0 where none does (the
    share then goes to the scratch)."""
    for K in CLUSTERS:
        if lib.fccf_fine_join_shared(Vf, M, K) >= 0:
            return K
    return 0


def _launch_join(T, table, tar_pts, tar_mask, params):
    """The join on CUDA tensors, in clusters of the least number of blocks
    that holds a candidate's share in shared memory, else with its share
    in a scratch."""
    lead, M = tuple(tar_mask.shape[:-1]), tar_mask.shape[-1]
    C, Vf = T.shape[-3], table.keys.shape[-1]
    P = math.prod(lead)
    ins = checked(
        ("T", "tar_pts", "tar_mask", "table.keys", "table.counts",
         "table.n_src", "table.cell_min", "table.cell_max"),
        (T, tar_pts, tar_mask, table.keys, table.counts, table.n_src,
         table.cell_min, table.cell_max),
        (torch.float32, torch.float32, torch.bool, torch.int64,
         torch.float32, torch.float32, torch.int32, torch.int32),
        (lead + (C, 4, 4), lead + (M, 3), lead + (M,), lead + (Vf,),
         lead + (Vf,), lead, lead + (3,), lead + (3,)))
    # The mask's count is exact as a float32 sum below 2^24.
    if P > 65535 or C > 65535 or M >= 2**24 or Vf < 1:
        raise ValueError(f"join: {P} pairs of {C} candidates, {M} points and "
                         f"{Vf} slots, want at most 65535 pairs and "
                         "candidates, fewer than 2^24 points and a slot")
    out = torch.empty(lead + (C,), dtype=torch.float32, device=T.device)
    if out.numel() == 0:
        return out
    lib = build()
    K = cluster_size(lib, Vf, M)
    scratch = None
    if K == 0:
        scratch = torch.empty(P * C * lib.fccf_fine_join_scratch(Vf, M),
                              dtype=torch.int32, device=T.device)
    with torch.cuda.device(T.device):  # the C entry launches on it
        rc = lib.fccf_fine_join(
            *(t.data_ptr() for t in ins + (out,)),
            None if scratch is None else scratch.data_ptr(), P, C, M, Vf,
            _inv(params.fine_voxel), K, stream(T.device))
    launched(rc, "fccf_fine_join", _THIS, "JOINS")
    return out


# -------------------------------------------------------------- entries --


def join(T, table, tar_pts, tar_mask, params):
    """Each candidate's fine score against its pair's table
    (``join_plain``): the kernel on a card."""
    with record_function("fine_kernels.join"):
        if device_type(T, "join") == "cpu":
            return join_plain(T, table, tar_pts, tar_mask, params)
        return _launch_join(T, table, tar_pts, tar_mask, params)
