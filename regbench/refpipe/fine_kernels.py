"""Fine verify's per-candidate join: the plain PyTorch version of the
kernel V (``join``: the target points' keys looked up in the source
table, counted by slot, and the score summed in ``fold_sum``'s tree), on
any device. A frozen copy of the plain versions in
``fccf_pcr_torch/ops/fine_kernels.py``."""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .batch import fold_sum, scatter_unique, small_matmul, take
from .voxelize import _inv, cell_index

# Keys are 30-bit packed cells in int64 (the JAX package's uint32 order);
# the all-ones uint32 sentinel sorts after every key.
SENTINEL = 0xFFFFFFFF


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


join = join_plain
