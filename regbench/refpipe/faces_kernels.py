"""The faces stage's plane fit and per-label sums: the plain PyTorch
versions of F1 (``plane_fit``) and F2 (``face_stats``,
``label_segment_sum``, ``label_order``), on any device. A frozen copy of
the plain versions in ``fccf_pcr_torch/ops/faces_kernels.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import eigen3
from .batch import take


class PlaneFit(NamedTuple):
    """F1's outputs, each (..., V) or (..., V, 3)."""

    normal: torch.Tensor         # unit normal, oriented toward the centroid
    curvature: torch.Tensor      # l0 / (l0 + l1 + l2)
    vvalid: torch.Tensor         # valid, enough points and planar
    residual_gate: torch.Tensor  # valid, enough points, not planar


def plane_fit_plain(cov, centroid, count, valid, global_centroid,
                    point_threshold, curvature_threshold):
    """F1's plain version: cov (..., V, 3, 3), centroid (..., V, 3), count
    (..., V) int32, valid (..., V) bool, global_centroid (..., 3) ->
    ``PlaneFit`` (FCCF.cpp:486-530)."""
    normal, curvature = eigen3.plane_fit_from_cov(cov)
    enough = count > point_threshold  # strictly > (:486)
    planar = curvature < curvature_threshold  # (:497)
    # Orient each normal toward the global centroid (:504-516).
    to_c = centroid - global_centroid[..., None, :]
    flip = torch.sum(to_c * normal, dim=-1) < 0.0
    return PlaneFit(
        normal=torch.where(flip[..., None], normal, -normal),
        curvature=curvature,
        vvalid=valid & enough & planar,
        residual_gate=valid & enough & ~planar,
    )


def sorted_labels(labels, valid, V):
    """The rows sorted stably by label (..., V): (seg_s, order), seg the
    label clamped to V - 1, or V for an invalid row."""
    seg = torch.where(valid, torch.clamp(labels, max=V - 1), V)
    return torch.sort(seg, dim=-1, stable=True)


def segment_sum_plain(seg_s, order, values, V):
    """Per-label sums (..., V, D) of ``values`` (..., n, D) over the rows
    sorted by label (``sorted_labels``): the rows taken in sorted order, a
    segmented inclusive scan (log2 n doubling steps, each adding the
    partial sum d rows back where that row has the same label, +0.0
    elsewhere), and each run's total written to its label's slot; rows
    labelled V or below 0 are dropped (as the one-hot contraction drops
    them) and other slots are 0. Each row of the leading
    batch dims is summed alone with the same adds."""
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
    ) & (seg_s >= 0) & (seg_s < V)
    dest = torch.where(last, seg_s, V)[..., None].expand(x.shape)
    out = torch.zeros(tuple(x.shape[:-2]) + (V + 1, x.shape[-1]),
                      dtype=x.dtype, device=x.device)
    out.scatter_(-2, dest, x)
    return out[..., :V, :]


def values_sum_plain(seg_s, order, values, V):
    """``label_segment_sum``'s plain version: sums (..., V) of one column
    ``values`` (..., n)."""
    return segment_sum_plain(seg_s, order, values[..., None], V)[..., 0]


def stat_columns(count, centroid, normal, valid):
    """The face statistics' columns (..., V, 8): [centroid * w, normal *
    w, w, 1], w = float(count) where valid, else 0."""
    dt = centroid.dtype
    w = torch.where(valid, count.to(dt), 0.0)
    return torch.cat(
        [centroid * w[..., None], normal * w[..., None], w[..., None],
         torch.ones_like(w[..., None])],
        dim=-1,
    )


def face_stats_plain(seg_s, order, count, centroid, normal, valid, V):
    """``face_stats``' plain version on the sorted labels: (centroid,
    normal, psize, vcount) of every slot, the sums of centroid * w and
    normal * w divided by psize (at least 1e-12), psize the sum of w, and
    vcount the rounded count of rows."""
    sums = segment_sum_plain(
        seg_s, order, stat_columns(count, centroid, normal, valid), V)
    csum, nsum = sums[..., 0:3], sums[..., 3:6]
    psize = sums[..., 6]
    vcount = torch.round(sums[..., 7]).to(torch.int32)
    denom = torch.clamp(psize, min=1e-12)[..., None]
    return csum / denom, nsum / denom, psize, vcount


def face_stats_by_label_plain(labels, valid, count, centroid, normal, V):
    """``face_stats``' plain version from the labels (F2's signature): the
    stable sort (``sorted_labels``), then ``face_stats_plain``."""
    seg_s, order = sorted_labels(labels, valid, V)
    return face_stats_plain(seg_s, order, count, centroid, normal, valid, V)


def values_sum_by_label_plain(values, labels, valid, V):
    """``label_segment_sum``'s plain version from the labels (F2's
    signature): the stable sort, then ``values_sum_plain``."""
    seg_s, order = sorted_labels(labels, valid, V)
    return values_sum_plain(seg_s, order, values, V)


plane_fit = plane_fit_plain
face_stats = face_stats_by_label_plain
label_segment_sum = values_sum_by_label_plain
label_order = sorted_labels
