"""Fine verification: voxel-occupancy overlap score on the residual clouds
(port of ``fccf_pcr_tpu/verify/fine.py``; ``fine_verify`` FCCF.cpp:785-839).

The table cloud's (sorted unique key, count) table is built once per
pair (``build_source_table``); every candidate transform then joins its
transformed cloud's keys with the table and scores each voxel holding
both with (s + t) * min(s, t) / max(s, t). The JAX package sorts [table
keys ++ candidate keys] a candidate; only the runs that begin with a
table entry score, so the port looks each key up in the table and counts
it at its slot (``ops/fine_kernels.py``: one kernel on a card).

Keys: 10 bits per axis with wraparound (30 bits) held in int64 (the JAX
package's uint32 order, with the all-ones sentinel above every key).
Target cells outside the table's bounding window are dropped before
packing, so wrapped keys stay injective for any pose; the alias flag
reports a table span of 1024 cells or more.

Both functions take leading batch dims (a pair axis): one table per pair,
and per pair its own candidates, scored against its own table and cloud.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .config import Capacities, FCCFParams
from . import fine_kernels, scan
from .fine_kernels import SENTINEL as _SENTINEL
from .fine_kernels import pack_cells as _pack_cells
from .sorting import cosort
from .voxelize import cell_index


def _cell_bounds(cells, mask):
    """Per-axis (min, max) over the valid cells (inverted when empty)."""
    big = 1 << 30
    kmin = torch.amin(torch.where(mask[..., None], cells, big), dim=-2)
    kmax = torch.amax(torch.where(mask[..., None], cells, -big), dim=-2)
    return kmin, kmax


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

    The join of [table keys ++ a candidate's transformed keys] is a lookup
    of each key in the table and two counts a table slot, then each scoring
    run's place and value and their ``fold_sum`` (``fine_kernels.join``:
    one kernel on a card, the counts in its shared memory; its plain
    version on the CPU).
    """
    lead = tuple(tar_mask.shape[:-1])
    cand = tuple(T.shape[len(lead):-2])
    T = T.reshape(lead + (-1, 4, 4))
    score = fine_kernels.join(T, table, tar_pts, tar_mask, params)
    aliased = table.aliased[..., None].expand(score.shape)
    return score.reshape(lead + cand), aliased.reshape(lead + cand)
