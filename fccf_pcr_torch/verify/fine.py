"""Fine verification: voxel-occupancy overlap score on the residual clouds
(port of ``fccf_pcr_tpu/verify/fine.py``; ``fine_verify`` FCCF.cpp:785-839).

The table cloud's (sorted unique key, count) table is built once per
pair; every candidate transform then sorts [table keys ++ its transformed
cloud keys] (a batch of join sorts, one row per candidate) and scores each
voxel holding both labels with (s + t) * min(s, t) / max(s, t).

Keys: 10 bits per axis with wraparound (30 bits), shifted left once to
carry the label in the low bit, held in int64 (the JAX package's uint32
order, with the all-ones sentinel still above every key). Target cells
outside the table's bounding window are dropped before packing, so
wrapped keys stay injective for any pose; the alias flag reports a table
span of 1024 cells or more.

Both functions take leading batch dims (a pair axis): one table per pair,
and per pair its own candidates, scored against its own table and cloud.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..config import Capacities, FCCFParams
from ..ops import scan
from ..ops.batch import fold_sum, small_matmul
from ..ops.sorting import cosort
from ..ops.voxelize import cell_index

_SENTINEL = 0xFFFFFFFF


def _cell_bounds(cells, mask):
    """Per-axis (min, max) over the valid cells (inverted when empty)."""
    big = 1 << 30
    kmin = torch.amin(torch.where(mask[..., None], cells, big), dim=-2)
    kmax = torch.amax(torch.where(mask[..., None], cells, -big), dim=-2)
    return kmin, kmax


def _pack_cells(cells, mask):
    kx = (cells[..., 0] & 1023).to(torch.int64)
    ky = (cells[..., 1] & 1023).to(torch.int64)
    kz = (cells[..., 2] & 1023).to(torch.int64)
    key = (kx << 20) | (ky << 10) | kz
    return torch.where(mask, key, _SENTINEL)


def _unique_counts(keys, cap):
    """Sorted unique keys + float counts of each row of ``keys`` (...,
    n) (capacity ``cap``, sentinel padded) and the overflow flag (more
    distinct keys than ``cap``)."""
    n = keys.shape[-1]
    dev = keys.device
    (s,) = cosort((keys,))
    valid = s != _SENTINEL
    first = torch.cat(
        [torch.ones_like(s[..., :1], dtype=torch.bool),
         s[..., 1:] != s[..., :-1]], dim=-1
    ) & valid
    n_unique = torch.sum(first, dim=-1, keepdim=True)
    seg = torch.clamp(scan.cumsum(first) - 1, max=cap)
    idx = torch.arange(n, device=dev).expand(s.shape)
    start = torch.full(tuple(s.shape[:-1]) + (cap + 1,), -1, dtype=torch.int64,
                       device=dev)
    start.scatter_(-1, torch.where(first, seg, cap), idx)
    start = start[..., :cap]
    slot = torch.arange(cap, device=dev)
    R = torch.clamp(n_unique, max=cap)
    occupied = slot < R
    n_valid_kept = torch.sum(valid & (seg < cap), dim=-1, keepdim=True)
    nxt_start = torch.cat([start[..., 1:], torch.zeros_like(start[..., :1])],
                          dim=-1)
    end = torch.where(slot == R - 1, n_valid_kept - 1, nxt_start - 1)
    counts = torch.where(occupied, (end - start + 1).to(torch.float32), 0.0)
    ukeys = torch.where(occupied, torch.gather(s, -1, torch.clamp(start, min=0)),
                        _SENTINEL)
    return ukeys, counts, n_unique[..., 0] > cap


class SourceTable(NamedTuple):
    """Leading batch dims (a pair axis) go first."""

    keys: torch.Tensor      # (..., Vf) int64 sorted unique voxel keys (sentinel padded)
    counts: torch.Tensor    # (..., Vf) float counts
    n_src: torch.Tensor     # (...) total table-cloud points
    overflow: torch.Tensor  # (...) bool, > max_fine_voxels distinct cells
    cell_min: torch.Tensor  # (..., 3) int32 per-axis min cell (join window)
    cell_max: torch.Tensor  # (..., 3) int32 per-axis max cell
    aliased: torch.Tensor   # (...) bool, span >= 1024 cells on some axis


def build_source_table(src_pts, src_mask, params: FCCFParams,
                       caps: Capacities) -> SourceTable:
    with record_function("fine.table"):
        cells = cell_index(src_pts, params.fine_voxel)
        keys = _pack_cells(cells, src_mask)
        kmin, kmax = _cell_bounds(cells, src_mask)
        ukeys, counts, overflow = _unique_counts(keys, caps.max_fine_voxels)
        return SourceTable(
            keys=ukeys,
            counts=counts,
            n_src=torch.sum(src_mask.to(torch.float32), dim=-1),
            overflow=overflow,
            cell_min=kmin,
            cell_max=kmax,
            aliased=torch.any(kmax - kmin >= 1024, dim=-1),
        )


def fine_verify(T, table: SourceTable, tar_pts, tar_mask, params, caps):
    """Score candidate transforms T (..., *cand, 4, 4) (:785-839) of each
    pair of the leading batch dims against its table and its cloud
    tar_pts (..., M, 3). Returns (score (..., *cand), aliased (...,
    *cand)).

    One join sort per candidate: table keys (label 0 in the low bit, so
    they lead their cell's run) and the candidate's transformed keys
    (label 1); each run is evaluated at its start, elementwise, with the
    next run start found by a reverse running min.
    """
    with record_function("fine.keys"):
        lead = tuple(tar_mask.shape[:-1])
        cand = tuple(T.shape[len(lead):-2])
        T = T.reshape(lead + (-1, 4, 4))
        C = T.shape[-3]
        dev = T.device
        R = T[..., :3, :3]
        t = T[..., :3, 3]
        tar_t = small_matmul(tar_pts[..., None, :, :], R.mT) + t[..., None, :]
        cells_t = cell_index(tar_t, params.fine_voxel)
        in_win = torch.all(
            (cells_t >= table.cell_min[..., None, None, :])
            & (cells_t <= table.cell_max[..., None, None, :]), dim=-1
        )
        keys_t = _pack_cells(cells_t, tar_mask[..., None, :] & in_win)

    with record_function("fine.join"):
        Vf = table.keys.shape[-1]
        M = keys_t.shape[-1]
        n = Vf + M
        ks2 = torch.where(table.keys != _SENTINEL, table.keys << 1, _SENTINEL)
        kt2 = torch.where(keys_t != _SENTINEL, (keys_t << 1) | 1, _SENTINEL)
        keys = torch.cat([ks2[..., None, :].expand(lead + (C, Vf)), kt2],
                         dim=-1)
        vals = torch.cat(
            [table.counts[..., None, :].expand(lead + (C, Vf)),
             torch.ones(lead + (C, M), dtype=torch.float32, device=dev)],
            dim=-1,
        )
        k_s, val_s = cosort((keys,), (vals,), dim=-1)
        src_s = (k_s & 1) == 0

    with record_function("fine.runs"):
        pos = torch.arange(n, device=dev)
        cell = k_s >> 1
        start_flag = torch.cat(
            [torch.ones_like(cell[..., :1], dtype=torch.bool),
             cell[..., 1:] != cell[..., :-1]],
            dim=-1,
        )
        marked = torch.where(start_flag, pos, n)
        nxt = scan.rev_cummin(marked)
        nxt = torch.cat([nxt[..., 1:], torch.full_like(nxt[..., :1], n)],
                        dim=-1)

    with record_function("fine.score"):
        has_src = start_flag & src_s
        s_cnt = torch.where(has_src, val_s, 0.0)
        run_len = (nxt - pos).to(torch.float32)
        t_cnt = run_len - has_src.to(torch.float32)
        live = start_flag & has_src & (t_cnt >= 1.0) & (k_s != _SENTINEL)
        mn = torch.minimum(s_cnt, t_cnt)
        mx = torch.maximum(s_cnt, t_cnt)
        # fold_sum: a library's long reduction splits its work by the number
        # of outputs, so its rounding would depend on the batch.
        similar = fold_sum(
            torch.where(live,
                        (s_cnt + t_cnt) * mn / torch.clamp(mx, min=1.0), 0.0),
            dim=-1,
        )
        total = table.n_src + torch.sum(tar_mask.to(torch.float32), dim=-1)
        score = similar / torch.clamp(total, min=1.0)[..., None]
        aliased = table.aliased[..., None].expand(score.shape)
    return score.reshape(lead + cand), aliased.reshape(lead + cand)
