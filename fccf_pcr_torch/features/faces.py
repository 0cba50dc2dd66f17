"""Planar-face extraction: voxel plane fits + parallel region growing
(port of ``fccf_pcr_tpu/features/faces.py``: ``extract_faces`` and
``faces_from_voxels``).

Face growth is connected components of the symmetric voxel-voxel affinity
(compare_normal / compare_plane on per-voxel stats), computed by min-label
propagation (``ops.label_prop``: the CUDA kernel on the GPU, the plain
version on the CPU), then a second propagation merges faces over the
compacted face representatives. Face statistics are segmented scans over
the voxels sorted by label, which are deterministic on every device and
the same for a pair in any batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..config import Capacities, FCCFParams
from ..ops import eigen3, geometry, scan
from ..ops.batch import fold_sum, take
from ..ops.label_prop import label_propagate
from ..ops.voxelize import compact, voxel_stats

_BIG = 2**30


class Faces(NamedTuple):
    """Fixed-capacity (F) planar faces, masked (``facenode``,
    FCCF.cpp:47-58); ``normal`` is the raw (non-unit) weighted average.
    Leading batch dims (a pair axis) go before F."""

    centroid: torch.Tensor     # (..., F, 3)
    normal: torch.Tensor       # (..., F, 3)
    point_size: torch.Tensor   # (..., F) float sum of member voxel point counts
    voxel_count: torch.Tensor  # (..., F) int32 member voxels
    theta: torch.Tensor        # (..., F) roughness = mean |angle(face n, voxel n)|
    valid: torch.Tensor        # (..., F) bool


def _label_segment_sum(values, labels, valid, V):
    """Per-label sums of ``values`` (..., V, D) over slot-index labels
    (..., V); invalid rows add nothing. A stable sort by label, a
    segmented inclusive scan (log2 V doubling steps, each adding the
    partial sum d rows back where that row has the same label), and each
    run's total written to its label's slot. Each row of the leading batch
    dims is summed alone with the same adds, so its sums do not depend on
    the batch it is in, on any device, and nothing is (V, V)-shaped."""
    seg = torch.where(valid, torch.clamp(labels, max=V - 1), V)
    seg_s, order = torch.sort(seg, dim=-1, stable=True)
    x = take(values, order)
    n = seg_s.shape[-1]
    d = 1
    while d < n:
        same = (seg_s[..., d:] == seg_s[..., :-d])[..., None]
        x = torch.cat(
            [x[..., :d, :], x[..., d:, :] + torch.where(same, x[..., :-d, :], 0.0)],
            dim=-2,
        )
        d *= 2
    last = torch.cat(
        [seg_s[..., 1:] != seg_s[..., :-1], torch.ones_like(seg_s[..., :1],
                                                             dtype=torch.bool)],
        dim=-1,
    ) & (seg_s < V)
    dest = torch.where(last, seg_s, V)[..., None].expand(x.shape)
    out = torch.zeros(tuple(x.shape[:-2]) + (V + 1, x.shape[-1]),
                      dtype=x.dtype, device=x.device)
    out.scatter_(-2, dest, x)
    return out[..., :V, :]


def _face_stats(labels, valid, count, centroid, normal, V):
    """Point-count-weighted segment stats per face label
    (FCCF.cpp:570-586 / :626-642)."""
    with record_function("face_stats"):
        dt = centroid.dtype
        w = torch.where(valid, count.to(dt), 0.0)
        stats = torch.cat(
            [centroid * w[..., None], normal * w[..., None], w[..., None],
             torch.ones_like(w[..., None])],
            dim=-1,
        )  # (..., V, 8)
        sums = _label_segment_sum(stats, labels, valid, V)
        csum, nsum = sums[..., 0:3], sums[..., 3:6]
        psize = sums[..., 6]
        vcount = torch.round(sums[..., 7]).to(torch.int32)
        denom = torch.clamp(psize, min=1e-12)[..., None]
        return csum / denom, nsum / denom, psize, vcount


def extract_faces(points, mask, params: FCCFParams, caps: Capacities):
    """points (..., N, 3), mask (..., N) -> (Faces, (sorted_pts,
    residual_mask), overflow): voxelizes at ``face_voxel_size`` itself
    (the non-fused face path, for a leaf that does not nest in the
    feature voxel)."""
    vs, sorted_pts, point_voxel = voxel_stats(
        points, mask, params.face_voxel_size, caps.max_voxels
    )
    return faces_from_voxels(vs, sorted_pts, point_voxel, params, caps)


def faces_from_voxels(vs, cloud_pts, point_voxel, params: FCCFParams,
                      caps: Capacities, voxel_start=None,
                      with_labels: bool = False):
    """Face growth + top-F selection from per-voxel stats, for each cloud
    of the leading batch dims (none, or a pair axis: both label-prop
    passes then run once for the whole batch).

    ``cloud_pts`` is the voxel-ordered cloud (..., N, 3) with
    ``point_voxel`` mapping each point to its voxel slot (== V when
    dropped). ``voxel_start`` is each voxel's first row in the sparse
    layout of ``downsample_and_voxelize``; None for the packed layout of
    ``voxel_stats``, whose voxel runs tile a prefix. Returns (Faces,
    (cloud_pts, residual_mask), overflow): the residual marks points of
    voxels that passed the point-count gate but failed the curvature
    gate (the reference's ``cloud_sub``, FCCF.cpp:527-530), consumed by
    fine verification.

    with_labels=True also returns (final_label, vvalid, order, fvalid):
    the per-slot face label, the planar gate and the top-F selection.
    """
    V = caps.max_voxels
    F = caps.max_faces
    dev = cloud_pts.device
    dt = cloud_pts.dtype
    ar = torch.arange(V, device=dev)
    lead = tuple(vs.valid.shape[:-1])

    with record_function("faces.plane_fit"):
        cloud_mask = point_voxel < V
        total = torch.sum(cloud_mask.to(dt), dim=-1)
        # fold_sum: a library's long reduction splits its work by the number
        # of outputs, so its rounding would depend on the batch.
        global_centroid = fold_sum(
            torch.where(cloud_mask[..., None], cloud_pts, 0.0), dim=-2
        ) / torch.clamp(total, min=1.0)[..., None]

        normal, curvature = eigen3.plane_fit_from_cov(vs.cov)

        enough = vs.count > params.voxel_point_threshold  # strictly > (:486)
        planar = curvature < params.curvature_threshold   # (:497)
        vvalid = vs.valid & enough & planar

        # Orient each normal toward the global centroid (:504-516).
        to_c = vs.centroid - global_centroid[..., None, :]
        flip = torch.sum(to_c * normal, dim=-1) < 0.0
        normal = torch.where(flip[..., None], normal, -normal)

    with record_function("faces.residual"):
        # Residual (non-planar) point mask (:527-530): a marker
        # (2 * run start + gate) is planted at each voxel's first row and
        # forward-filled by a running max (run starts strictly increase).
        residual_gate = vs.valid & enough & ~planar
        N = point_voxel.shape[-1]
        if voxel_start is None:
            # Packed layout: run k starts at the exclusive cumsum of counts.
            start_v = scan.cumsum(vs.count) - vs.count.long()
        else:
            start_v = voxel_start.long()
        dest = torch.where(vs.valid, start_v, N)
        marker = torch.zeros(lead + (N + 1,), dtype=torch.int64, device=dev)
        marker.scatter_(-1, dest, start_v * 2 + residual_gate.long())
        gate_pt = (scan.cummax(marker[..., :N]) & 1) == 1
        residual_mask = gate_pt & (point_voxel < V)

    with record_function("faces.grow"):
        # Pass 1: voxel -> face growth (compare_normal 5 deg, l1/k1)
        # (:536-593). Occupied slots are a prefix, so each cloud's max planar
        # slot bounds the kernel's sweeps over it.
        n_occ = torch.amax(torch.where(vvalid, ar, -1), dim=-1) + 1
        labels1 = label_propagate(
            normal, vs.centroid, vvalid, params.normal_thresh1, params.l1,
            params.k1, bound=n_occ, max_iters=params.label_prop_iters,
        ).long()

        c1, n1, p1, vc1 = _face_stats(
            labels1, vvalid, vs.count, vs.centroid, normal, V
        )
        rep1 = vvalid & (labels1 == ar)

    with record_function("faces.merge"):
        # Pass 2: face <-> face merge (compare_normal 8 deg, l2/k2)
        # (:595-648) over the representatives, compacted (stably) to a slot
        # prefix so the merge sweeps cost n_reps^2.
        n_reps, _, cvalid, c_n1, c_c1, slot_of = compact(
            rep1, V, n1, c1, ar.expand(rep1.shape), batch_dims=len(lead)
        )
        labels2_c = label_propagate(
            c_n1, c_c1, cvalid, params.normal_thresh2, params.l2, params.k2,
            bound=n_reps, max_iters=params.label_prop_iters,
        ).long()
        comp_of_slot = scan.cumsum(rep1) - 1
        lbl_c = take(labels2_c, torch.clamp(comp_of_slot, 0, V - 1))
        labels2 = torch.where(
            rep1, take(slot_of, torch.clamp(lbl_c, max=V - 1)), _BIG
        )

        final_label = torch.where(
            vvalid, take(labels2, torch.clamp(labels1, max=V - 1)), _BIG
        )
        cF, nF, pF, vcF = _face_stats(
            final_label, vvalid, vs.count, vs.centroid, normal, V
        )
        repF = vvalid & (final_label == ar)

    with record_function("faces.roughness"):
        # Per-voxel angle to its face's normal -> per-face roughness
        # (:660-667).
        fl = torch.clamp(final_label, max=V - 1)
        ang = torch.where(
            vvalid, torch.abs(geometry.angle_deg(take(nF, fl), normal)), 0.0
        )
        asum = _label_segment_sum(ang[..., None], final_label, vvalid,
                                  V)[..., 0]
        theta = asum / torch.clamp(vcF.to(dt), min=1.0)

    with record_function("faces.top"):
        # Top-F faces by member-voxel count, desc; ties by slot index asc
        # (range_face :409-427 is stable): one stable sort.
        sort_key = torch.where(repF, vcF, -1)
        order = torch.sort(-sort_key, dim=-1, stable=True).indices[..., :F]
        fvalid = take(sort_key, order) > 0

        def top(x, zero=0.0):
            m = fvalid.reshape(fvalid.shape + (1,) * (x.dim() - fvalid.dim()))
            return torch.where(m, take(x, order), zero)

        faces = Faces(
            centroid=top(cF),
            normal=top(nF),
            point_size=top(pF),
            voxel_count=top(vcF, 0).to(torch.int32),
            theta=top(theta),
            valid=fvalid,
        )
    if with_labels:
        return faces, (cloud_pts, residual_mask), vs.overflow, (
            final_label, vvalid, order, fvalid
        )
    return faces, (cloud_pts, residual_mask), vs.overflow
