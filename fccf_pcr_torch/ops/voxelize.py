"""Voxel hashing, grouping and per-voxel statistics (port of the main-path
parts of ``fccf_pcr_tpu/ops/voxelize.py``).

Voxelization is a hash -> stable sort -> prefix-sum segment reduce over
fixed-capacity arrays, exactly as in the JAX package: cells are anchored
at the absolute origin (``floor(p / res)``), ordered (kz, ky, kx) with kx
fastest, re-indexed relative to the cloud's min occupied cell and packed
into ONE int32 sort key. Payloads ride the sort (``ops.sorting.cosort``).
Scatters only ever write unique indices (plus a dump slot past the end
that is sliced off), so every result is deterministic on the GPU too.

Ported: ``_pack_cells``/``_unpack_cells``, ``sorted_segment_reduce``,
``_kth_true_positions`` (scatter form only: no host sync),
``voxel_grid_downsample``, ``compact``, ``voxel_stats`` (the non-fused
face path) and both layouts of ``downsample_and_voxelize``: one combined
key, and the two-key ``wide_extent`` layout of the building-scale
presets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .sorting import cosort

_SENT = 2**31 - 1  # int32 max: invalid points sort last

# Packed-key extent limits (cells): z-major like PCL leaf ordering.
_XBITS, _YBITS, _ZBITS = 11, 10, 10


class VoxelStats(NamedTuple):
    """Per-voxel plane statistics (fixed capacity V, masked)."""

    centroid: torch.Tensor  # (V, 3)
    cov: torch.Tensor       # (V, 3, 3) normalized covariance
    count: torch.Tensor     # (V,) int32 points in voxel
    valid: torch.Tensor     # (V,) bool occupied
    overflow: torch.Tensor  # () bool, more voxels than capacity


def _first_flags(k_s):
    """True at row 0 and wherever the sorted key changes."""
    return torch.cat(
        [torch.ones_like(k_s[:1], dtype=torch.bool), k_s[1:] != k_s[:-1]]
    )


def _pack_cells(cells, mask, bits=(_XBITS, _YBITS, _ZBITS)):
    """Pack integer 3-D cells (N, 3) int32 into one int32 sort key
    (z-major, relative to the min occupied cell); invalid points get the
    sentinel. Extent limit 2^bx x 2^by x (2^bz - 2) cells; wider clouds
    clip into border cells and raise the overflow flag.
    Returns (key, kmin, ovf)."""
    bx, by, bz = bits
    lim = torch.tensor(
        [(1 << bx) - 1, (1 << by) - 1, (1 << bz) - 2],
        dtype=cells.dtype, device=cells.device,
    )
    masked = torch.where(mask[:, None], cells, _SENT)
    kmin = torch.amin(masked, dim=0)
    rel = cells - kmin
    ovf = torch.any(mask[:, None] & (rel > lim))
    rel = torch.clamp(rel, min=torch.zeros_like(lim), max=lim)
    key = (rel[..., 2] << (bx + by)) | (rel[..., 1] << bx) | rel[..., 0]
    return torch.where(mask, key, _SENT), kmin, ovf


def _unpack_cells(key, kmin, bits=(_XBITS, _YBITS, _ZBITS)):
    """Exact elementwise inverse of ``_pack_cells`` (valid keys only)."""
    bx, by, bz = bits
    kx = key & ((1 << bx) - 1)
    ky = (key >> bx) & ((1 << by) - 1)
    kz = key >> (bx + by)
    return torch.stack([kx, ky, kz], dim=-1) + kmin


def _inv(res):
    """float32 reciprocal of a cell size. Cells are floor(p * (1 / res)):
    the reference's compiled form of floor(p / res), so points on a cell
    boundary fall into the same cell as in the reference."""
    return float(np.float32(1.0) / np.float32(res))


def _fms(a, b, c):
    """a - b * c in float32 with one rounding (a fused multiply-subtract,
    as the reference's compiled arithmetic does), for float32 a, b, c:
    b * c is exact in float64 and the difference of close values too."""
    return (a.double() - b.double() * c.double()).to(a.dtype)


def cell_index(points, res):
    """Integer cell (int32) of each point at resolution ``res``,
    absolute-anchored: floor(p / res), as compiled by the reference."""
    return torch.floor(points * _inv(res)).to(torch.int32)


def prefix_sum(x):
    """Inclusive prefix sum along dim 0, associated as a base-16 blocked
    scan: sequential sums inside rows of 16, the row totals scanned the
    same way one level up, and each level's exclusive total added back.
    This is the association of XLA's cumsum on the CPU (the reference's
    goldens), so float32 prefixes agree bit for bit on every device, and
    the error stays O(eps log16 N) of the prefix magnitude."""
    m = x.shape[0]
    if m <= 16:
        cols = [x[0]]
        for c in range(1, m):
            cols.append(cols[-1] + x[c])
        return torch.stack(cols)
    rows = -(-m // 16)
    pad = x.new_zeros((rows * 16 - m,) + tuple(x.shape[1:]))
    X = torch.cat([x, pad]).reshape((rows, 16) + tuple(x.shape[1:]))
    cols = [X[:, 0]]
    for c in range(1, 16):
        cols.append(cols[-1] + X[:, c])
    P = torch.stack(cols, dim=1)
    inc = prefix_sum(P[:, 15])
    exc = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    return (P + exc[:, None]).reshape((rows * 16,) + tuple(x.shape[1:]))[:m]


def _scatter_unique(size, dest, values):
    """out[dest[r]] = values[r] for unique dest < size, 0 elsewhere; rows
    aimed at ``size`` land in a dump slot that is sliced off."""
    out = torch.zeros((size + 1,), dtype=values.dtype, device=values.device)
    out.scatter_(0, dest.long(), values)
    return out[:size]


def sorted_segment_reduce(values, seg, num_segments, return_start=False):
    """Sums + counts per segment for a NONDECREASING, consecutive
    segment-id vector (``seg == num_segments`` = dropped rows).

    Per-segment sums are differences of the running prefix sum at run
    boundaries; callers feed O(cell-size) anchored values so the prefix
    magnitude stays small. Returns (sums (S, D), counts (S,) int32) and,
    with return_start=True, the run-start row per slot (0 where empty).
    """
    n = values.shape[0]
    S = num_segments
    dev = values.device
    ps = prefix_sum(values)
    idx = torch.arange(n, device=dev)
    first = _first_flags(seg)
    live = seg < S
    start = _scatter_unique(S, torch.where(first & live, seg, S), idx)
    R = torch.sum(first & live)
    n_valid = torch.sum(live)
    slot = torch.arange(S, device=dev)
    occupied = slot < R
    nxt_start = torch.cat([start[1:], torch.zeros_like(start[:1])])
    end = torch.where(slot == R - 1, n_valid - 1, nxt_start - 1)
    end = torch.where(occupied, end, -1)
    zero = torch.zeros((), dtype=values.dtype, device=dev)
    ps_end = torch.where(occupied[:, None], ps[torch.clamp(end, min=0)], zero)
    ps_start = torch.where(
        (occupied & (start > 0))[:, None], ps[torch.clamp(start - 1, min=0)],
        zero,
    )
    sums = ps_end - ps_start
    counts = torch.where(occupied, end - start + 1, 0).to(torch.int32)
    if return_start:
        return sums, counts, torch.where(occupied, start, 0)
    return sums, counts


def _kth_true_positions(flag, S):
    """pos[k] = index of the (k+1)-th True in ``flag`` (N,); slots
    k >= count are garbage (callers mask by count). One S-bounded scatter
    of the row indices by rank. Returns (pos (S,) int64, count () int64)."""
    n = flag.shape[0]
    c = torch.cumsum(flag.to(torch.int64), dim=0)
    count = c[-1]
    k = c - 1
    dest = torch.where(flag & (k < S), k, S)
    pos = _scatter_unique(S, dest, torch.arange(n, device=flag.device))
    return pos, count


def voxel_grid_downsample(points, mask, res):
    """PCL-VoxelGrid-equivalent centroid per occupied cell
    (FCCF.cpp:1377-1387). Returns (out_points (N, 3), out_mask (N,),
    overflow); output order is ascending (kz, ky, kx)."""
    cap = points.shape[0]
    dt = points.dtype
    key, kmin, key_ovf = _pack_cells(cell_index(points, res), mask)
    w = mask.to(dt)
    # Cell-anchored coordinates keep the prefix-sum magnitude small; the
    # corner is re-derived exactly from the sorted key and added back.
    res32 = torch.tensor(np.float32(res), device=points.device)
    v = _fms(points, torch.floor(points * _inv(res)), res32) * w[:, None]
    k_s, vx, vy, vz = cosort((key,), (v[:, 0], v[:, 1], v[:, 2]))
    m_s = k_s != _SENT
    seg_id = torch.cumsum(_first_flags(k_s).to(torch.int64), dim=0) - 1
    seg = torch.where(m_s, torch.clamp(seg_id, max=cap), cap)
    sums, cnts, start = sorted_segment_reduce(
        torch.stack([vx, vy, vz], dim=-1), seg, cap, return_start=True
    )
    anchor_s = torch.where(
        m_s[:, None],
        _unpack_cells(torch.where(m_s, k_s, 0), kmin).to(dt) * res,
        0.0,
    )
    occ = cnts > 0
    anchor_seg = torch.where(occ[:, None], anchor_s[start], 0.0)
    out = sums / torch.clamp(cnts[:, None].to(dt), min=1.0)
    return out + anchor_seg, occ, key_ovf


def compact(valid, capacity, *payloads):
    """Stable masked compaction: pack valid entries (in order) into the
    first slots of fixed-capacity outputs.

    Returns (count int32, overflow, out_valid (capacity,), *out_payloads).
    Entries beyond capacity are dropped (overflow raised). Payloads share
    ``valid``'s leading dims, which are flattened.
    """
    lead = valid.dim()
    valid = valid.reshape(-1)
    L = valid.shape[0]
    dev = valid.device
    pos = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    count = pos[-1] + 1
    overflow = count > capacity
    dest = torch.where(valid & (pos < capacity), pos, capacity)
    src = _scatter_unique(capacity, dest, torch.arange(L, device=dev))
    out_valid = torch.arange(capacity, device=dev) < count
    outs = []
    for p in payloads:
        p = p.reshape((L,) + tuple(p.shape[lead:]))
        g = p[src]
        m = out_valid.reshape((capacity,) + (1,) * (g.dim() - 1))
        outs.append(torch.where(m, g, torch.zeros((), dtype=p.dtype, device=dev)))
    return (
        torch.clamp(count, max=capacity).to(torch.int32),
        overflow,
        out_valid,
        *outs,
    )


def _cov_from_moments(mu, e):
    """(V, 3, 3) covariance from means mu (V, 3) and second moments
    e (V, 6) ordered xx, yy, zz, xy, xz, yz."""
    cxx = _fms(e[:, 0], mu[:, 0], mu[:, 0])
    cyy = _fms(e[:, 1], mu[:, 1], mu[:, 1])
    czz = _fms(e[:, 2], mu[:, 2], mu[:, 2])
    cxy = _fms(e[:, 3], mu[:, 0], mu[:, 1])
    cxz = _fms(e[:, 4], mu[:, 0], mu[:, 2])
    cyz = _fms(e[:, 5], mu[:, 1], mu[:, 2])
    return torch.stack(
        [
            torch.stack([cxx, cxy, cxz], dim=-1),
            torch.stack([cxy, cyy, cyz], dim=-1),
            torch.stack([cxz, cyz, czz], dim=-1),
        ],
        dim=-2,
    )


def _segment_mean_cov(pts_anchored, anchor, seg, V):
    """Per-segment mean + covariance over a sorted segment-id vector
    (``seg == V`` = dropped rows), one pass on cell-anchored coordinates:
    cov = E[p'p'^T] - mu' mu'^T. The anchor is constant within a segment
    and read exactly at each run's first row. Returns (mean, cov, cnt)."""
    dt = pts_anchored.dtype
    w = (seg < V).to(dt)
    p = pts_anchored * w[:, None]
    a = pts_anchored
    outer6 = torch.stack(
        [p[:, 0] * a[:, 0], p[:, 1] * a[:, 1], p[:, 2] * a[:, 2],
         p[:, 0] * a[:, 1], p[:, 0] * a[:, 2], p[:, 1] * a[:, 2]],
        dim=-1,
    )
    sums, cnt, start = sorted_segment_reduce(
        torch.cat([p, outer6], dim=-1), seg, V, return_start=True
    )
    occ = cnt > 0
    anchor_seg = torch.where(occ[:, None], anchor[start], 0.0)
    cntf = torch.clamp(cnt.to(dt), min=1.0)
    mu = sums[:, 0:3] / cntf[:, None]
    e = sums[:, 3:9] / cntf[:, None]
    return mu + anchor_seg, _cov_from_moments(mu, e), cnt


def voxel_stats(points, mask, res, num_voxels):
    """Per-voxel centroid + covariance + count over fixed capacity V (the
    octree voxel loop of ``face_extrate``, FCCF.cpp:481-534).

    Returns (stats, sorted_points (N, 3), point_voxel (N,)): the cloud
    re-ordered by voxel cell (payloads ride the sort) and each sorted
    point's voxel slot (== V for dropped or invalid points)."""
    V = num_voxels
    dt = points.dtype
    key, kmin, key_ovf = _pack_cells(cell_index(points, res), mask)
    k_s, px, py, pz = cosort((key,), (points[:, 0], points[:, 1], points[:, 2]))
    pts_s = torch.stack([px, py, pz], dim=-1)
    m_s = k_s != _SENT
    seg_id = torch.cumsum(_first_flags(k_s).to(torch.int64), dim=0) - 1
    seg = torch.where(m_s & (seg_id < V), seg_id, V)

    # Per-segment anchor (cell corner), exact from the sorted key itself.
    anchor = torch.where(
        m_s[:, None],
        _unpack_cells(torch.where(m_s, k_s, 0), kmin).to(dt) * res,
        0.0,
    )
    mean, cov, cnt = _segment_mean_cov(pts_s - anchor, anchor, seg, V)

    nvalid_seg = torch.amax(torch.where(m_s, seg_id, -1)) + 1
    overflow = (nvalid_seg > V) | key_ovf
    stats = VoxelStats(
        centroid=mean, cov=cov, count=cnt, valid=cnt > 0, overflow=overflow
    )
    return stats, pts_s, seg


def downsample_and_voxelize(points, mask, leaf, face_res, num_voxels,
                            wide_extent: bool = False):
    """Fused VoxelGrid downsample + feature-voxel statistics: ONE sort.

    ``face_res`` must be an integer multiple of ``leaf``, so leaf cells
    nest inside feature voxels and one combined key (face cell in the
    high bits, within-face leaf index in the low bits) gives both
    groupings; ``wide_extent`` sorts by two keys instead (face cell, then
    within-face leaf index), for the full 2047 x 1023 x 1022-cell face
    extent of building-scale scenes. Returns (down_pts (N, 3), down_mask
    (N,), stats, point_voxel (N,), voxel_start (V,)): down points sit
    SPARSE at each leaf run's last row (address through down_mask),
    point_voxel is each down point's feature-voxel slot (== V when
    dropped) and voxel_start[k] the row of voxel k's first down point
    (== N for unoccupied slots).
    """
    n = points.shape[0]
    V = num_voxels
    dev = points.device
    dt = points.dtype
    ratio = int(round(face_res / leaf))
    if abs(face_res - ratio * leaf) >= 1e-9 * max(face_res, 1.0):
        raise ValueError(
            "fused voxelization needs face_res to be an integer multiple "
            "of leaf"
        )

    k = cell_index(points, leaf)
    fcell = torch.div(k, ratio, rounding_mode="floor")
    within = k - fcell * ratio
    wkey = (within[..., 2] * ratio + within[..., 1]) * ratio + within[..., 0]

    # Points ride the sort in face-cell-anchored coordinates.
    anchor_in = torch.where(mask[:, None], fcell.to(dt) * face_res, 0.0)
    p_in = torch.where(mask[:, None], points - anchor_in, 0.0)

    payload = (p_in[:, 0], p_in[:, 1], p_in[:, 2])
    if wide_extent:
        # Two keys: the face cell at the default 11/10/10 bits, then the
        # within-face leaf index; a leaf run starts where either changes.
        fkey, kmin, ovf = _pack_cells(fcell, mask)
        wkey_m = torch.where(mask, wkey, _SENT)
        fk_s, wk_s, px, py, pz = cosort((fkey, wkey_m), payload)
        m_s = fk_s != _SENT
        bits = (_XBITS, _YBITS, _ZBITS)
        leaf_first = _first_flags(fk_s) | _first_flags(wk_s)
    else:
        # ONE combined int32 key: the face-cell bit budget is what remains
        # of 31 bits after the within-face leaf index (ratio^3 values).
        bits_w = max((ratio**3 - 1).bit_length(), 1)
        bits_f = 31 - bits_w
        bz = bits_f // 3
        by = bits_f // 3
        bx = bits_f - by - bz
        bits = (bx, by, bz)
        fkey, kmin, ovf = _pack_cells(fcell, mask, bits=bits)
        ckey = torch.where(mask, (fkey << bits_w) | wkey, _SENT)
        ck_s, px, py, pz = cosort((ckey,), payload)
        m_s = ck_s != _SENT
        fk_s = ck_s >> bits_w
        leaf_first = _first_flags(ck_s)

    pts_s = torch.stack([px, py, pz], dim=-1)  # anchored coords
    anchor_s = torch.where(
        m_s[:, None],
        _unpack_cells(torch.where(m_s, fk_s, 0), kmin, bits=bits).to(dt)
        * face_res,
        0.0,
    )
    face_first = _first_flags(fk_s)

    # Leaf reduce, sparse layout: each leaf run's stats land at its last
    # row. A running max forward-fills each run's start index.
    idx = torch.arange(n, device=dev)
    leaf_last = torch.cat([leaf_first[1:], torch.ones_like(leaf_first[:1])]) & m_s
    start_fill = torch.cummax(torch.where(leaf_first, idx, 0), dim=0).values
    w = m_s.to(dt)
    ff = (face_first & m_s).to(dt)
    vals1 = torch.cat([pts_s * w[:, None], ff[:, None]], dim=-1)
    ps1 = prefix_sum(vals1)
    ps_prev = torch.where(
        (start_fill > 0)[:, None], ps1[torch.clamp(start_fill - 1, min=0)], 0.0
    )
    run = ps1 - ps_prev  # at row i: column sums over [run start, i]
    cnt_leaf = torch.clamp((idx - start_fill + 1).to(dt), min=1.0)

    down_mask = leaf_last
    down_anchored = torch.where(
        down_mask[:, None], run[:, 0:3] / cnt_leaf[:, None], 0.0
    )
    down_anchor = torch.where(down_mask[:, None], anchor_s, 0.0)
    down_pts = down_anchored + down_anchor
    # Feature-voxel id of each down point: face starts seen so far, minus
    # one. The f32 flag cumsum is exact below 2^24 rows.
    face_of_leaf = ps1[:, 3].to(torch.int64) - 1
    point_voxel = torch.where(
        down_mask & (face_of_leaf >= 0) & (face_of_leaf < V), face_of_leaf, V
    )
    face_first_down = down_mask & (run[:, 3] > 0.5)

    # Feature-voxel stats: prefix-sum differences at voxel boundaries.
    # V+1 start positions: the extra slot is the first DROPPED voxel's
    # start, which clamps the last kept slot's window under overflow.
    start_full, n_faces_seen = _kth_true_positions(face_first_down, V + 1)
    start_tbl = start_full[:V]
    slot = torch.arange(V, device=dev)
    R = torch.clamp(n_faces_seen, max=V)
    occupied = slot < R
    p = down_anchored
    outer6 = torch.stack(
        [
            p[:, 0] * p[:, 0],
            p[:, 1] * p[:, 1],
            p[:, 2] * p[:, 2],
            p[:, 0] * p[:, 1],
            p[:, 0] * p[:, 2],
            p[:, 1] * p[:, 2],
        ],
        dim=-1,
    )
    vals2 = torch.cat([p, outer6, down_mask.to(dt)[:, None]], dim=-1)
    ps2 = prefix_sum(vals2)
    safe_start = torch.where(occupied, start_tbl, 0)
    nxt = torch.cat([start_tbl[1:], torch.zeros_like(start_tbl[:1])])
    last_end = torch.where(
        n_faces_seen > V, torch.clamp(start_full[V] - 1, min=0), n - 1
    )
    end = torch.where(slot == R - 1, last_end, torch.clamp(nxt - 1, min=0))
    end = torch.where(occupied, end, 0)
    ps_end = torch.where(occupied[:, None], ps2[end], 0.0)
    ps_st = torch.where(
        (occupied & (safe_start > 0))[:, None],
        ps2[torch.clamp(safe_start - 1, min=0)],
        0.0,
    )
    sums2 = ps_end - ps_st
    cnt = torch.where(occupied, sums2[:, 9].to(torch.int32), 0).to(torch.int32)
    cntf = torch.clamp(cnt.to(dt), min=1.0)
    mu = sums2[:, 0:3] / cntf[:, None]
    anchor_face = torch.where(occupied[:, None], anchor_s[safe_start], 0.0)
    mean = mu + anchor_face
    e = sums2[:, 3:9] / cntf[:, None]
    cov = _cov_from_moments(mu, e)

    overflow = (n_faces_seen > V) | ovf
    stats = VoxelStats(
        centroid=mean, cov=cov, count=cnt, valid=cnt > 0, overflow=overflow
    )
    voxel_start = torch.where(occupied, start_tbl, n)
    return down_pts, down_mask, stats, point_voxel, voxel_start
