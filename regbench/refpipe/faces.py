"""Planar-face extraction: voxel plane fits + parallel region growing
(port of ``fccf_pcr_tpu/features/faces.py``: ``extract_faces`` and
``faces_from_voxels``).

Face growth is connected components of the symmetric voxel-voxel affinity
(compare_normal / compare_plane on per-voxel stats), computed by min-label
propagation (``ops.label_prop``: the CUDA kernel on the GPU, the plain
version on the CPU), then a second propagation merges faces over the
compacted face representatives. Face statistics are segmented scans over
the voxels sorted by label, which are deterministic on every device and
the same for a pair in any batch. The plane fit and the segment sums are
``ops.faces_kernels``' F1 and F2 (CUDA kernels on the card, their plain
versions on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .config import Capacities, FCCFParams
from . import faces_kernels, geometry, scan
from .batch import fold_sum, take
from .label_prop import label_propagate
from .voxelize import compact, voxel_stats

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


def _face_stats(labels, valid, count, centroid, normal, V):
    """Point-count-weighted segment stats per face label
    (FCCF.cpp:570-586 / :626-642): F2 on a card."""
    with record_function("face_stats"):
        return faces_kernels.face_stats(labels, valid, count, centroid,
                                        normal, V)


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

        # F1 on a card: the plane fit, the gates and the orientation
        # (:486-530).
        fit = faces_kernels.plane_fit(
            vs.cov, vs.centroid, vs.count, vs.valid, global_centroid,
            params.voxel_point_threshold, params.curvature_threshold,
        )
        normal, vvalid = fit.normal, fit.vvalid

    with record_function("faces.residual"):
        # Residual (non-planar) point mask (:527-530): a marker
        # (2 * run start + gate) is planted at each voxel's first row and
        # forward-filled by a running max (run starts strictly increase).
        residual_gate = fit.residual_gate
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
        asum = faces_kernels.label_segment_sum(ang, final_label, vvalid, V)
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
