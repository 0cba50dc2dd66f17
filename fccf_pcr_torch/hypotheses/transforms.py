"""Closed-form rigid-transform hypothesis generation (port of
``fccf_pcr_tpu/hypotheses/transforms.py``: the base-matching loop
FCCF.cpp:1414-1427 and ``computer_transform`` :841-1018).

  1. (B1 x B2) compatibility (|angle difference| < 5 deg, same type),
     compacted to M matched base pairs in b1-major order.
  2. Per match, batched over M: the closed-form R = R2*R1, the
     third-plane fan-out over (source face s, target face t) with the
     3-plane translation solve, and the fallback translation.
  3. Hypotheses compacted to H slots in the reference's enumeration order
     (b1, b2, then s, then t, fallback last).

Reference quirks are kept as in the JAX package: raw (non-unit) face
normals feed every dot product, d22 pairs the untransformed target
centroid with the R1-rotated m2, and the A-matrix rows are the raw
source normals.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Capacities, FCCFParams
from ..features.faces import Faces
from ..ops import geometry
from ..ops.batch import small_matmul, take
from ..ops.voxelize import compact
from .bases import Bases


class Hypotheses(NamedTuple):
    """Leading batch dims (a pair axis) go before H."""

    quat: torch.Tensor      # (..., H, 4) w,x,y,z
    t: torch.Tensor         # (..., H, 3)
    type_: torch.Tensor     # (..., H) int32 in {0,1,2}
    valid: torch.Tensor     # (..., H) bool
    count: torch.Tensor     # (...) int32 valid hypotheses kept
    overflow: torch.Tensor  # (...) bool


def _inv3x3(A):
    """Batched 3x3 inverse via the adjugate."""
    a = A[..., 0, 0]; b = A[..., 0, 1]; c = A[..., 0, 2]  # noqa: E702
    d = A[..., 1, 0]; e = A[..., 1, 1]; f = A[..., 1, 2]  # noqa: E702
    g = A[..., 2, 0]; h = A[..., 2, 1]; i = A[..., 2, 2]  # noqa: E702
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det = torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _match_all(f1: Faces, f2: Faces, i1, j1, i2, j2, params: FCCFParams):
    """``_match_one`` of the JAX package, batched over the M matches of
    each face set of the leading batch dims (...). Returns quat (..., M,
    4), T3 (..., M, Fs, Ft, 3), pair_ok (..., M, Fs, Ft), t_fb (..., M,
    3), fallback (..., M)."""
    M = i1.shape[-1]
    F = f1.valid.shape[-1]
    shp = tuple(i1.shape) + (F, F)  # (..., M, Fs, Ft)
    ar = torch.arange(F, device=i1.device)
    n1 = take(f1.normal, i1)
    m1 = take(f1.normal, j1)
    n2 = take(f2.normal, i2)
    m2 = take(f2.normal, j2)

    R, m2r = geometry.rotation_between_planes(n1, m1, n2, m2)

    # Third source planes (:906-927): normalized n1 x m1 against raw n_s.
    n1cm1 = geometry.normalize(geometry.cross(n1, m1))
    span_s = torch.abs(geometry.dot(f1.normal[..., None, :, :],
                                    n1cm1[..., None, :]))
    src_ok = (
        f1.valid[..., None, :]
        & (span_s > params.third_plane_threshold)
        & (ar != i1[..., None])
        & (ar != j1[..., None])
    )

    # Rotated target face normals/centroids (:936-948).
    nt_r = small_matmul(f2.normal[..., None, :, :], R.mT)  # (..., M, Ft, 3)
    ct_r = small_matmul(f2.centroid[..., None, :, :], R.mT)
    n2cm2 = geometry.normalize(geometry.cross(n2, m2r))  # quirk (:930)
    tar_ok = (
        f2.valid[..., None, :]
        & (torch.abs(geometry.dot(nt_r, n2cm2[..., None, :]))
           > params.third_plane_threshold)
        & (ar != i2[..., None])
        & (ar != j2[..., None])
    )
    ang3 = geometry.angle_deg(f1.normal[..., None, :, None, :],
                              nt_r[..., None, :, :])
    pair_ok = (
        src_ok[..., :, None] & tar_ok[..., None, :]
        & (ang3 < params.third_normal_threshold)
    )

    # 3-plane translation solve (:969-987): rows of A are raw source normals.
    c11 = take(f1.centroid, i1)
    c12 = take(f1.centroid, j1)
    c21 = take(f2.centroid, i2)
    c22 = take(f2.centroid, j2)
    d11 = geometry.dot(c11, n1)
    d12 = geometry.dot(c12, m1)
    d21 = geometry.dot(c21, n2)
    d22 = geometry.dot(c22, m2r)  # reference quirk (:973)
    d13 = geometry.dot(f1.centroid, f1.normal)  # (..., Fs)
    d23 = geometry.dot(ct_r, nt_r)              # (..., M, Ft)
    D = torch.stack(
        [
            (d11 - d21)[..., None, None].expand(shp),
            (d12 - d22)[..., None, None].expand(shp),
            d13[..., None, :, None] - d23[..., None, :],
        ],
        dim=-1,
    )  # (..., M, Fs, Ft, 3)
    A = torch.stack(
        [
            n1[..., None, :].expand(shp[:-1] + (3,)),
            m1[..., None, :].expand(shp[:-1] + (3,)),
            f1.normal[..., None, :, :].expand(shp[:-1] + (3,)),
        ],
        dim=-2,
    )  # (..., M, Fs, 3, 3)
    P = small_matmul(_inv3x3(small_matmul(A.mT, A)), A.mT)
    T3 = small_matmul(D, P.mT)  # T3[s, t, i] = sum_j P[s, i, j] D[s, t, j]

    # Fallback translation (:1000-1017).
    w11, w12 = take(f1.point_size, i1), take(f1.point_size, j1)
    w21, w22 = take(f2.point_size, i2), take(f2.point_size, j2)
    src_center = (c11 * w11[..., None] + c12 * w12[..., None]) / torch.clamp(
        w11 + w12, min=1e-12
    )[..., None]
    tar_center = (c21 * w21[..., None] + c22 * w22[..., None]) / torch.clamp(
        w21 + w22, min=1e-12
    )[..., None]
    t_fb = src_center - geometry.matvec(R, tar_center)

    quat = geometry.matrix_to_quat(R)
    fallback = ~torch.any(pair_ok.flatten(-2), dim=-1)
    return quat, T3, pair_ok, t_fb, fallback


def generate_hypotheses(f1: Faces, f2: Faces, b1: Bases, b2: Bases,
                        params: FCCFParams, caps: Capacities) -> Hypotheses:
    """Hypotheses of each face-set pair of the leading batch dims."""
    lead = tuple(b1.valid.shape[:-1])
    nb = len(lead)
    B = b1.valid.shape[-1]
    F = f1.valid.shape[-1]
    M = caps.max_matches
    H = caps.max_hypotheses
    dev = f1.valid.device

    # (B1 x B2) compatibility (:1420), flattened b1-major.
    match = (
        b1.valid[..., :, None]
        & b2.valid[..., None, :]
        & (torch.abs(b1.angle[..., :, None] - b2.angle[..., None, :])
           < params.angle_same)
        & (b1.type_[..., :, None] == b2.type_[..., None, :])
    )
    sq = lead + (B, B)
    (_, m_overflow, m_valid, mi1, mj1, mi2, mj2, mtype) = compact(
        match, M, b1.i[..., :, None].expand(sq), b1.j[..., :, None].expand(sq),
        b2.i[..., None, :].expand(sq), b2.j[..., None, :].expand(sq),
        b1.type_[..., :, None].expand(sq), batch_dims=nb,
    )

    quat, T3, pair_ok, t_fb, fb = _match_all(f1, f2, mi1, mj1, mi2, mj2, params)

    # Slots per match: F*F third-plane hits (s-major) then 1 fallback.
    S = F * F + 1
    slot_valid = torch.cat(
        [(pair_ok & m_valid[..., None, None]).flatten(-2),
         (fb & m_valid)[..., None]],
        dim=-1,
    )  # (..., M, S)
    slot_t = torch.cat([T3.flatten(-3, -2), t_fb[..., None, :]], dim=-2)

    # Two-stage compaction: each match's first PER_MATCH hits in slot
    # order (a stable descending sort of the negated slot index, whose
    # valid entries are unique), then one compaction of M*PER_MATCH slots.
    PER_MATCH = min(caps.per_match_hits, S)
    ar_s = torch.arange(S, device=dev)
    neg = torch.where(slot_valid, -ar_s, -S - 1)
    vals, idxs = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, idxs = vals[..., :PER_MATCH], idxs[..., :PER_MATCH]
    hit_valid = vals > -S - 1
    row_overflow = torch.any(torch.sum(slot_valid, dim=-1) > PER_MATCH, dim=-1)

    flat = torch.arange(M, device=dev)[:, None] * S + idxs  # (..., M, K)
    (h_count, h_overflow, h_valid, hflat) = compact(hit_valid, H, flat,
                                                    batch_dims=nb)
    hm = torch.div(hflat, S, rounding_mode="floor")
    ht = torch.where(h_valid[..., None], take(slot_t.flatten(-3, -2), hflat),
                     0.0)
    hq = torch.where(h_valid[..., None], take(quat, hm), 0.0)
    htype = torch.where(h_valid, take(mtype, hm), 0).to(torch.int32)
    return Hypotheses(
        quat=hq,
        t=ht,
        type_=htype,
        valid=h_valid,
        count=h_count,
        overflow=h_overflow | m_overflow | row_overflow,
    )
