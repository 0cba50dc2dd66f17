"""The hypotheses stage: the plain PyTorch versions of H1 (``matches``,
``bases``), H2 (``slots``) and H3 (``emit``), on any device. A frozen
copy of the plain versions in ``fccf_pcr_torch/ops/hypotheses_kernels.py``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import geometry
from .batch import small_matmul, take
from .voxelize import compact


class Matches(NamedTuple):
    """H1's outputs: ``compact``'s of the (B1 x B2) mask."""

    count: torch.Tensor     # (...) int32 matches kept
    overflow: torch.Tensor  # (...) bool more than M
    valid: torch.Tensor     # (..., M) bool
    i1: torch.Tensor        # (..., M) int64 face indices of the base pair
    j1: torch.Tensor
    i2: torch.Tensor
    j2: torch.Tensor
    type_: torch.Tensor     # (..., M) int32 the base type


class Slots(NamedTuple):
    """H2's outputs: each match's first K = PER_MATCH hits (hit k of match
    m is valid where k < count[m]), 0 for the matches past the count. A
    row's translations past its count are no output: the plain version
    writes zeros there, H2 leaves them unwritten, and H3 reads only the
    hits (``kept_hits`` zeroes them, to compare the two)."""

    quat: torch.Tensor          # (..., M, 4) the match's rotation
    t: torch.Tensor             # (..., M, K, 3) the hit's translation
    count: torch.Tensor         # (..., M) int32 hits kept
    row_overflow: torch.Tensor  # (..., M) bool more than K valid slots


def pair_indices(F: int, device="cpu"):
    """Static (i, j) pairs, i < j, in the reference's nested-loop order."""
    ij = torch.triu_indices(F, F, offset=1, device=device)
    return ij[0], ij[1]


def bases_plain(faces, params):
    """The bases' plain version: (i, j, angle, type_, valid) of each face
    set, (..., B) with B = F (F - 1) / 2, i and j expanded views."""
    F = faces.valid.shape[-1]
    ii, jj = pair_indices(F, faces.valid.device)
    angle = geometry.angle_deg(faces.normal[..., ii, :],
                               faces.normal[..., jj, :])
    valid = (
        faces.valid[..., ii]
        & faces.valid[..., jj]
        & (angle > params.angle_min)
        & (angle < params.angle_max)
    )
    rough_i = faces.theta[..., ii] > params.rough_threshold
    rough_j = faces.theta[..., jj] > params.rough_threshold
    # both smooth -> 0, both rough -> 1, mixed -> 2 (FCCF.cpp:454-461)
    type_ = torch.where(
        rough_i == rough_j, torch.where(rough_i, 1, 0), 2
    ).to(torch.int32)
    return (ii.expand(valid.shape), jj.expand(valid.shape), angle, type_,
            valid)


def matches_plain(f1, f2, params, max_matches) -> Matches:
    """H1's plain version: the bases (i, j, angle, type_, valid) of both
    clouds (``bases_plain``), their (B1 x B2) compatibility
    (FCCF.cpp:1420), flattened b1-major, compacted to ``max_matches``."""
    i1, j1, a1, t1, v1 = bases_plain(f1, params)
    i2, j2, a2, t2, v2 = bases_plain(f2, params)
    angle_same = params.angle_same
    lead = tuple(v1.shape[:-1])
    B = v1.shape[-1]
    match = (
        v1[..., :, None]
        & v2[..., None, :]
        & (torch.abs(a1[..., :, None] - a2[..., None, :]) < angle_same)
        & (t1[..., :, None] == t2[..., None, :])
    )
    sq = lead + (B, B)
    return Matches(*compact(
        match, max_matches, i1[..., :, None].expand(sq),
        j1[..., :, None].expand(sq), i2[..., None, :].expand(sq),
        j2[..., None, :].expand(sq), t1[..., :, None].expand(sq),
        batch_dims=len(lead)))


def inv3x3(A):
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


def match_all(f1, f2, i1, j1, i2, j2, params):
    """``_match_one`` of the JAX package, batched over the M matches of
    each face set of the leading batch dims (...). Returns quat (..., M,
    4), T3 (..., M, Fs, Ft, 3), pair_ok (..., M, Fs, Ft), t_fb (..., M,
    3), fallback (..., M)."""
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
    P = small_matmul(inv3x3(small_matmul(A.mT, A)), A.mT)
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


def slots_plain(f1, f2, m: Matches, params, per_match_hits) -> Slots:
    """H2's plain version: ``match_all`` on every match, its slots (F * F
    third-plane hits s-major, then the fallback) valid where the match
    is, and its first PER_MATCH valid slots in slot order (a stable
    descending sort of the negated slot index, whose valid entries are
    unique: the JAX package's ``lax.top_k``)."""
    F = f1.valid.shape[-1]
    dev = f1.valid.device
    quat, T3, pair_ok, t_fb, fb = match_all(f1, f2, m.i1, m.j1, m.i2, m.j2,
                                            params)
    S = F * F + 1
    slot_valid = torch.cat(
        [(pair_ok & m.valid[..., None, None]).flatten(-2),
         (fb & m.valid)[..., None]],
        dim=-1,
    )  # (..., M, S)
    slot_t = torch.cat([T3.flatten(-3, -2), t_fb[..., None, :]], dim=-2)
    K = min(per_match_hits, S)
    ar_s = torch.arange(S, device=dev)
    neg = torch.where(slot_valid, -ar_s, -S - 1)
    vals, idxs = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, idxs = vals[..., :K], idxs[..., :K]
    hit_valid = vals > -S - 1
    n_valid = torch.sum(slot_valid, dim=-1)
    return Slots(
        quat=torch.where(m.valid[..., None], quat, 0.0),
        t=torch.where(hit_valid[..., None], take(slot_t, idxs), 0.0),
        count=torch.clamp(n_valid, max=K).to(torch.int32),
        row_overflow=n_valid > K,
    )


def kept_hits(s: Slots) -> Slots:
    """``s`` with each row's translations past its count zeroed: the
    plain version's, and a kernel's to compare with it."""
    K = s.t.shape[-2]
    hit = torch.arange(K, device=s.t.device) < s.count[..., None]
    return s._replace(t=torch.where(hit[..., None], s.t, 0.0))


def emit_plain(s: Slots, m: Matches, max_hypotheses):
    """H3's plain version: the M * K hits (hit k of match m valid where k
    < count[m]) compacted to ``max_hypotheses`` (each hit's match and
    translation), the quaternion and type gathered from its match.
    Returns (quat, t, type_, valid, count, overflow) as ``Hypotheses``'
    fields."""
    nb = s.count.dim() - 1
    M, K = s.t.shape[-3:-1]
    dev = s.count.device
    hit = torch.arange(K, device=dev) < s.count[..., None]  # (..., M, K)
    row = torch.arange(M, device=dev)[:, None].expand(hit.shape)
    (h_count, h_overflow, h_valid, hm, ht) = compact(
        hit, max_hypotheses, row, s.t, batch_dims=nb)
    hq = torch.where(h_valid[..., None], take(s.quat, hm), 0.0)
    htype = torch.where(h_valid, take(m.type_, hm), 0).to(torch.int32)
    overflow = h_overflow | m.overflow | torch.any(s.row_overflow, dim=-1)
    return hq, ht, htype, h_valid, h_count, overflow


bases = bases_plain
matches = matches_plain
slots = slots_plain
emit = emit_plain
