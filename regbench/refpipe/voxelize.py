"""Voxel hashing, grouping and per-voxel statistics (port of the main-path
parts of ``fccf_pcr_tpu/ops/voxelize.py``).

Voxelization is a hash -> stable sort -> prefix-sum segment reduce over
fixed-capacity arrays, exactly as in the JAX package: cells are anchored
at the absolute origin (``floor(p / res)``), ordered (kz, ky, kx) with kx
fastest, re-indexed relative to the cloud's min occupied cell and packed
into ONE int32 sort key. Payloads ride the sort (``ops.sorting.cosort``).
Scatters only ever write unique indices (plus a dump slot past the end
that is sliced off), so every result is deterministic on the GPU too.

Every function takes leading batch dims (a cloud is (..., N, 3), its mask
(..., N)), as the JAX package's functions do under ``jax.vmap``: sorts,
scans and segment reductions run along each row, so row k of a batch is
row k alone, bit for bit.

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
from torch.profiler import record_function

from . import scan
from .batch import constant, scatter_unique, take
from .scan import prefix_sum
from .sorting import cosort

_SENT = 2**31 - 1  # int32 max: invalid points sort last

# Packed-key extent limits (cells): z-major like PCL leaf ordering.
_XBITS, _YBITS, _ZBITS = 11, 10, 10


class VoxelStats(NamedTuple):
    """Per-voxel plane statistics (fixed capacity V, masked); leading
    batch dims go before V."""

    centroid: torch.Tensor  # (..., V, 3)
    cov: torch.Tensor       # (..., V, 3, 3) normalized covariance
    count: torch.Tensor     # (..., V) int32 points in voxel
    valid: torch.Tensor     # (..., V) bool occupied
    overflow: torch.Tensor  # (...) bool, more voxels than capacity


def _first_flags(k_s):
    """True at each row's first entry and wherever the sorted key
    changes along the last axis."""
    return torch.cat(
        [torch.ones_like(k_s[..., :1], dtype=torch.bool),
         k_s[..., 1:] != k_s[..., :-1]],
        dim=-1,
    )


def _pack_cells(cells, mask, bits=(_XBITS, _YBITS, _ZBITS)):
    """Pack integer 3-D cells (..., N, 3) int32 into one int32 sort key
    (z-major, relative to each row's min occupied cell); invalid points
    get the sentinel. Extent limit 2^bx x 2^by x (2^bz - 2) cells; wider
    clouds clip into border cells and raise the overflow flag.
    Returns (key, kmin (..., 3), ovf (...))."""
    bx, by, bz = bits
    lim = constant(((1 << bx) - 1, (1 << by) - 1, (1 << bz) - 2),
                   cells.dtype, cells.device)
    masked = torch.where(mask[..., None], cells, _SENT)
    kmin = torch.amin(masked, dim=-2)
    rel = cells - kmin[..., None, :]
    ovf = torch.any(mask[..., None] & (rel > lim), dim=-1).any(dim=-1)
    rel = torch.clamp(rel, min=torch.zeros_like(lim), max=lim)
    key = (rel[..., 2] << (bx + by)) | (rel[..., 1] << bx) | rel[..., 0]
    return torch.where(mask, key, _SENT), kmin, ovf


def _unpack_cells(key, kmin, bits=(_XBITS, _YBITS, _ZBITS)):
    """Exact elementwise inverse of ``_pack_cells`` (valid keys only):
    key (..., N), kmin (..., 3)."""
    bx, by, bz = bits
    kx = key & ((1 << bx) - 1)
    ky = (key >> bx) & ((1 << by) - 1)
    kz = key >> (bx + by)
    return torch.stack([kx, ky, kz], dim=-1) + kmin[..., None, :]


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


def sorted_segment_reduce(values, seg, num_segments, return_start=False):
    """Sums + counts per segment for a NONDECREASING, consecutive
    segment-id row (``seg == num_segments`` = dropped rows): values
    (..., n, D), seg (..., n).

    Per-segment sums are differences of the running prefix sum at run
    boundaries; callers feed O(cell-size) anchored values so the prefix
    magnitude stays small. Returns (sums (..., S, D), counts (..., S)
    int32) and, with return_start=True, the run-start row per slot (0
    where empty).
    """
    n = values.shape[-2]
    S = num_segments
    dev = values.device
    ps = prefix_sum(values, dim=-2)
    idx = torch.arange(n, device=dev).expand(seg.shape)
    first = _first_flags(seg)
    live = seg < S
    start = scatter_unique(S, torch.where(first & live, seg, S), idx)
    R = torch.sum(first & live, dim=-1, keepdim=True)
    n_valid = torch.sum(live, dim=-1, keepdim=True)
    slot = torch.arange(S, device=dev)
    occupied = slot < R
    nxt_start = torch.cat([start[..., 1:], torch.zeros_like(start[..., :1])],
                          dim=-1)
    end = torch.where(slot == R - 1, n_valid - 1, nxt_start - 1)
    end = torch.where(occupied, end, -1)
    zero = torch.zeros((), dtype=values.dtype, device=dev)
    ps_end = torch.where(occupied[..., None],
                         take(ps, torch.clamp(end, min=0)), zero)
    ps_start = torch.where(
        (occupied & (start > 0))[..., None],
        take(ps, torch.clamp(start - 1, min=0)), zero,
    )
    sums = ps_end - ps_start
    counts = torch.where(occupied, end - start + 1, 0).to(torch.int32)
    if return_start:
        return sums, counts, torch.where(occupied, start, 0)
    return sums, counts


def _kth_true_positions(flag, S):
    """pos[..., k] = index of the (k+1)-th True in each row of ``flag``
    (..., N); slots k >= count are garbage (callers mask by count). One
    S-bounded scatter of the row indices by rank. Returns (pos (..., S)
    int64, count (...) int64)."""
    with record_function("kth"):
        n = flag.shape[-1]
        c = scan.cumsum(flag)
        count = c[..., -1]
        k = c - 1
        dest = torch.where(flag & (k < S), k, S)
        pos = scatter_unique(S, dest, torch.arange(n, device=flag.device)
                             .expand(flag.shape))
        return pos, count


def voxel_grid_downsample(points, mask, res):
    """PCL-VoxelGrid-equivalent centroid per occupied cell
    (FCCF.cpp:1377-1387). Returns (out_points (..., N, 3), out_mask
    (..., N), overflow (...)); each row's output is in ascending (kz, ky,
    kx) order."""
    cap = points.shape[-2]
    dt = points.dtype
    key, kmin, key_ovf = _pack_cells(cell_index(points, res), mask)
    w = mask.to(dt)
    # Cell-anchored coordinates keep the prefix-sum magnitude small; the
    # corner is re-derived exactly from the sorted key and added back.
    res32 = torch.full((), float(np.float32(res)), dtype=dt,
                       device=points.device)
    v = _fms(points, torch.floor(points * _inv(res)), res32) * w[..., None]
    k_s, vx, vy, vz = cosort((key,), (v[..., 0], v[..., 1], v[..., 2]))
    m_s = k_s != _SENT
    seg_id = scan.cumsum(_first_flags(k_s)) - 1
    seg = torch.where(m_s, torch.clamp(seg_id, max=cap), cap)
    sums, cnts, start = sorted_segment_reduce(
        torch.stack([vx, vy, vz], dim=-1), seg, cap, return_start=True
    )
    anchor_s = torch.where(
        m_s[..., None],
        _unpack_cells(torch.where(m_s, k_s, 0), kmin).to(dt) * res,
        0.0,
    )
    occ = cnts > 0
    anchor_seg = torch.where(occ[..., None], take(anchor_s, start), 0.0)
    out = sums / torch.clamp(cnts[..., None].to(dt), min=1.0)
    return out + anchor_seg, occ, key_ovf


def compact(valid, capacity, *payloads, batch_dims: int = 0):
    """Stable masked compaction: pack valid entries (in order) into the
    first slots of fixed-capacity outputs.

    The first ``batch_dims`` dims of ``valid`` are batch dims, compacted
    row by row; its other dims are flattened, as are the payloads' dims
    that match them. Returns (count int32, overflow, out_valid (...,
    capacity), *out_payloads), each with the batch dims leading. Entries
    beyond capacity are dropped (overflow raised).
    """
    with record_function("compact"):
        lead = tuple(valid.shape[:batch_dims])
        inner = valid.dim()
        valid = valid.reshape(lead + (-1,))
        L = valid.shape[-1]
        dev = valid.device
        pos = scan.cumsum(valid) - 1
        count = pos[..., -1] + 1
        overflow = count > capacity
        dest = torch.where(valid & (pos < capacity), pos, capacity)
        src = scatter_unique(capacity, dest,
                             torch.arange(L, device=dev).expand(valid.shape))
        out_valid = torch.arange(capacity, device=dev) < count[..., None]
        outs = []
        for p in payloads:
            p = p.reshape(lead + (L,) + tuple(p.shape[inner:]))
            g = take(p, src)
            m = out_valid.reshape(
                out_valid.shape + (1,) * (g.dim() - out_valid.dim()))
            outs.append(torch.where(
                m, g, torch.zeros((), dtype=p.dtype, device=dev)))
        return (
            torch.clamp(count, max=capacity).to(torch.int32),
            overflow,
            out_valid,
            *outs,
        )


def _cov_from_moments(mu, e):
    """(..., 3, 3) covariance from means mu (..., 3) and second moments
    e (..., 6) ordered xx, yy, zz, xy, xz, yz."""
    cxx = _fms(e[..., 0], mu[..., 0], mu[..., 0])
    cyy = _fms(e[..., 1], mu[..., 1], mu[..., 1])
    czz = _fms(e[..., 2], mu[..., 2], mu[..., 2])
    cxy = _fms(e[..., 3], mu[..., 0], mu[..., 1])
    cxz = _fms(e[..., 4], mu[..., 0], mu[..., 2])
    cyz = _fms(e[..., 5], mu[..., 1], mu[..., 2])
    return torch.stack(
        [
            torch.stack([cxx, cxy, cxz], dim=-1),
            torch.stack([cxy, cyy, cyz], dim=-1),
            torch.stack([cxz, cyz, czz], dim=-1),
        ],
        dim=-2,
    )


def _outer6(p, a):
    """The six distinct products of p and a (..., 3): xx, yy, zz, xy, xz,
    yz, p's component first."""
    return torch.stack(
        [p[..., 0] * a[..., 0], p[..., 1] * a[..., 1], p[..., 2] * a[..., 2],
         p[..., 0] * a[..., 1], p[..., 0] * a[..., 2], p[..., 1] * a[..., 2]],
        dim=-1,
    )


def _segment_mean_cov(pts_anchored, anchor, seg, V):
    """Per-segment mean + covariance over a sorted segment-id row
    (``seg == V`` = dropped rows), one pass on cell-anchored coordinates:
    cov = E[p'p'^T] - mu' mu'^T. The anchor is constant within a segment
    and read exactly at each run's first row. Returns (mean, cov, cnt)."""
    dt = pts_anchored.dtype
    w = (seg < V).to(dt)
    p = pts_anchored * w[..., None]
    sums, cnt, start = sorted_segment_reduce(
        torch.cat([p, _outer6(p, pts_anchored)], dim=-1), seg, V,
        return_start=True,
    )
    occ = cnt > 0
    anchor_seg = torch.where(occ[..., None], take(anchor, start), 0.0)
    cntf = torch.clamp(cnt.to(dt), min=1.0)
    mu = sums[..., 0:3] / cntf[..., None]
    e = sums[..., 3:9] / cntf[..., None]
    return mu + anchor_seg, _cov_from_moments(mu, e), cnt


def voxel_stats(points, mask, res, num_voxels):
    """Per-voxel centroid + covariance + count over fixed capacity V (the
    octree voxel loop of ``face_extrate``, FCCF.cpp:481-534).

    Returns (stats, sorted_points (..., N, 3), point_voxel (..., N)): the
    cloud re-ordered by voxel cell (payloads ride the sort) and each
    sorted point's voxel slot (== V for dropped or invalid points)."""
    V = num_voxels
    dt = points.dtype
    key, kmin, key_ovf = _pack_cells(cell_index(points, res), mask)
    k_s, px, py, pz = cosort(
        (key,), (points[..., 0], points[..., 1], points[..., 2]))
    pts_s = torch.stack([px, py, pz], dim=-1)
    m_s = k_s != _SENT
    seg_id = scan.cumsum(_first_flags(k_s)) - 1
    seg = torch.where(m_s & (seg_id < V), seg_id, V)

    # Per-segment anchor (cell corner), exact from the sorted key itself.
    anchor = torch.where(
        m_s[..., None],
        _unpack_cells(torch.where(m_s, k_s, 0), kmin).to(dt) * res,
        0.0,
    )
    mean, cov, cnt = _segment_mean_cov(pts_s - anchor, anchor, seg, V)

    nvalid_seg = torch.amax(torch.where(m_s, seg_id, -1), dim=-1) + 1
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
    extent of building-scale scenes. Returns (down_pts (..., N, 3),
    down_mask (..., N), stats, point_voxel (..., N), voxel_start (...,
    V)): down points sit SPARSE at each leaf run's last row (address
    through down_mask), point_voxel is each down point's feature-voxel
    slot (== V when dropped) and voxel_start[k] the row of voxel k's
    first down point (== N for unoccupied slots).
    """
    n = points.shape[-2]
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
    anchor_in = torch.where(mask[..., None], fcell.to(dt) * face_res, 0.0)
    p_in = torch.where(mask[..., None], points - anchor_in, 0.0)

    payload = (p_in[..., 0], p_in[..., 1], p_in[..., 2])
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

    anchor_s = torch.where(
        m_s[..., None],
        _unpack_cells(torch.where(m_s, fk_s, 0), kmin, bits=bits).to(dt)
        * face_res,
        0.0,
    )
    face_first = _first_flags(fk_s)

    with record_function("voxelize.leaf"):
        # Leaf reduce, sparse layout: each leaf run's stats land at its last
        # row. A running max forward-fills each run's start index.
        idx = torch.arange(n, device=dev)
        leaf_last = torch.cat(
            [leaf_first[..., 1:], torch.ones_like(leaf_first[..., :1])], dim=-1
        ) & m_s
        start_fill = scan.cummax(torch.where(leaf_first, idx, 0))
        # Prefix sums of [p w, ff] (anchored coords p, w = float(m_s), ff
        # = float(face_first & m_s)), formed from the payloads in the
        # kernel on a card.
        ps1 = scan.leaf_prefix_sums(px, py, pz, m_s, face_first)
        ps_prev = torch.where(
            (start_fill > 0)[..., None],
            take(ps1, torch.clamp(start_fill - 1, min=0)), 0.0,
        )
        run = ps1 - ps_prev  # at row i: column sums over [run start, i]
        cnt_leaf = torch.clamp((idx - start_fill + 1).to(dt), min=1.0)

        down_mask = leaf_last
        down_anchored = torch.where(
            down_mask[..., None], run[..., 0:3] / cnt_leaf[..., None], 0.0
        )
        down_anchor = torch.where(down_mask[..., None], anchor_s, 0.0)
        down_pts = down_anchored + down_anchor
        # Feature-voxel id of each down point: face starts seen so far, minus
        # one. The f32 flag cumsum is exact below 2^24 rows.
        face_of_leaf = ps1[..., 3].to(torch.int64) - 1
        point_voxel = torch.where(
            down_mask & (face_of_leaf >= 0) & (face_of_leaf < V),
            face_of_leaf, V,
        )
        face_first_down = down_mask & (run[..., 3] > 0.5)

    with record_function("voxelize.voxels"):
        # Feature-voxel stats: prefix-sum differences at voxel boundaries.
        # V+1 start positions: the extra slot is the first DROPPED voxel's
        # start, which clamps the last kept slot's window under overflow.
        start_full, n_faces_seen = _kth_true_positions(face_first_down, V + 1)
        start_tbl = start_full[..., :V]
        slot = torch.arange(V, device=dev)
        R = torch.clamp(n_faces_seen, max=V)[..., None]
        occupied = slot < R
        # Prefix sums of [p, _outer6(p, p), float(down_mask)], formed from
        # p and the mask in the kernel on a card.
        ps2 = scan.moment_prefix_sums(down_anchored, down_mask)
        safe_start = torch.where(occupied, start_tbl, 0)
        nxt = torch.cat(
            [start_tbl[..., 1:], torch.zeros_like(start_tbl[..., :1])], dim=-1)
        last_end = torch.where(
            n_faces_seen > V, torch.clamp(start_full[..., V] - 1, min=0), n - 1
        )[..., None]
        end = torch.where(slot == R - 1, last_end, torch.clamp(nxt - 1, min=0))
        end = torch.where(occupied, end, 0)
        ps_end = torch.where(occupied[..., None], take(ps2, end), 0.0)
        ps_st = torch.where(
            (occupied & (safe_start > 0))[..., None],
            take(ps2, torch.clamp(safe_start - 1, min=0)),
            0.0,
        )
        sums2 = ps_end - ps_st
        cnt = torch.where(occupied, sums2[..., 9].to(torch.int32),
                          0).to(torch.int32)
        cntf = torch.clamp(cnt.to(dt), min=1.0)
        mu = sums2[..., 0:3] / cntf[..., None]
        anchor_face = torch.where(occupied[..., None],
                                  take(anchor_s, safe_start), 0.0)
        mean = mu + anchor_face
        e = sums2[..., 3:9] / cntf[..., None]
        cov = _cov_from_moments(mu, e)

        overflow = (n_faces_seen > V) | ovf
        stats = VoxelStats(
            centroid=mean, cov=cov, count=cnt, valid=cnt > 0, overflow=overflow
        )
        voxel_start = torch.where(occupied, start_tbl, n)
    return down_pts, down_mask, stats, point_voxel, voxel_start
