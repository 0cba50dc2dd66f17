"""The reference of the register step: ``register_batch`` registers P
pairs of down-sampled clouds as one batch, and ``pre_downsample`` makes
those clouds from raw ones, in plain PyTorch on any device. A frozen
copy of ``fccf_pcr_torch/pipeline/register.py``'s eager step
(``_register_batch``) and ``pre_downsample``, over frozen copies of the
plain versions of every kernel of the port: the same stages in the same
order (NaN removal, the fused downsample and voxelization, faces,
hypotheses, clusters, quick verify, LM refinement, fine verify, fusion).

``register_pair(src, tar)`` returns T mapping the SOURCE cloud into the
TARGET frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .cluster import cluster_hypotheses
from .faces import extract_faces, faces_from_voxels
from .fuse import fuse_transforms
from .transforms import generate_hypotheses
from . import geometry
from .batch import take
from .voxelize import compact, downsample_and_voxelize, voxel_grid_downsample
from .fine import build_source_table, fine_verify
from .quick import match_faces, refine_transform

STATUS_VOXEL_OVERFLOW = 1
STATUS_HYPOTHESIS_OVERFLOW = 2
STATUS_DEGENERATE = 4  # no type scored > 0: identity returned
STATUS_REP_OVERFLOW = 8
STATUS_RESIDUAL_OVERFLOW = 16
STATUS_FINE_OVERFLOW = 32  # fine-verify table (target residual) overflow
STATUS_FINE_ALIAS = 64     # fine-verify table span > 1024 cells/axis


class RegistrationResult(NamedTuple):
    """One pair's result; a batch's has a leading pair axis on each."""

    transform: torch.Tensor       # (4, 4) source -> target
    quick_score: torch.Tensor     # (3,) best quick score per type
    fine_score: torch.Tensor      # (3,)
    n_faces: torch.Tensor         # (2,) int32 faces in target/source clouds
    n_hypotheses: torch.Tensor    # () int32
    status: torch.Tensor          # () int32 bit flags
    type_transform: torch.Tensor  # (3, 4, 4) per-type best refined transform
    type_score: torch.Tensor      # (3,) combined score of each winner
    kept: torch.Tensor            # (3,) bool, passed the fusion gates


def set_precision():
    """Full float32 everywhere: TF32 would inject ~1e-3 relative noise,
    enough to flip the cos-threshold predicates (cos 5 deg = 0.9962)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _split(nt, P):
    """The two halves of a NamedTuple of tensors stacked along dim 0."""
    return type(nt)(*(x[:P] for x in nt)), type(nt)(*(x[P:] for x in nt))


def _pad_rows(pts, mask, n):
    """(P, N, 3) points + (P, N) mask with masked zero rows appended up
    to n rows."""
    with record_function("downsample"):
        extra = n - pts.shape[1]
        if extra == 0:
            return pts, mask
        P = pts.shape[0]
        return (torch.cat([pts, pts.new_zeros((P, extra, 3))], dim=1),
                torch.cat([mask, mask.new_zeros((P, extra))], dim=1))


def register_batch(src_pts, src_mask, tar_pts, tar_mask, params, caps):
    """Register P pairs: (P, Ns, 3) / (P, Nt, 3) points + (P, Ns) /
    (P, Nt) masks. The shorter cloud is padded with masked rows to the
    longer one's length, so that the 2P clouds stack; masked rows are
    dropped by every stage, as the JAX package's separate runs of the two
    clouds drop them."""
    set_precision()
    P = src_pts.shape[0]
    n = max(src_pts.shape[1], tar_pts.shape[1])
    src_pts, src_mask = _pad_rows(src_pts, src_mask, n)
    tar_pts, tar_mask = _pad_rows(tar_pts, tar_mask, n)
    dev = src_pts.device
    f32 = src_pts.dtype
    # The downsample fuses with the feature voxelization (one sort per
    # cloud) when the leaf nests integrally in the feature voxel.
    ratio = params.face_voxel_size / params.leaf_size
    fused = abs(ratio - round(ratio)) < 1e-9 * max(ratio, 1.0)

    # NaN removal (:1372-1375), on the 2P clouds: target clouds first
    # (the reference's face_vecter1), then the sources.
    with record_function("downsample"):
        pts = torch.cat([tar_pts, src_pts])
        msk = torch.cat([tar_mask, src_mask])
        msk = msk & torch.all(torch.isfinite(pts), dim=-1)
        pts = torch.where(msk[..., None], pts, 0.0)

    with record_function("faces"):
        if fused:
            with record_function("voxelize"):
                d, _, vs, pv, vstart = downsample_and_voxelize(
                    pts, msk, params.leaf_size, params.face_voxel_size,
                    caps.max_voxels, wide_extent=caps.wide_extent,
                )
            faces, (res_pts, res_mask), ovf = faces_from_voxels(
                vs, d, pv, params, caps, voxel_start=vstart)
        else:
            d, dm, d_ovf = voxel_grid_downsample(pts, msk, params.leaf_size)
            faces, (res_pts, res_mask), f_ovf = extract_faces(
                d, dm, params, caps)
            ovf = f_ovf | d_ovf
        # f1 = target clouds, f2 = sources.
        f1, f2 = _split(faces, P)

    with record_function("hypotheses"):
        # Both face sets' bases are formed with the matches (in H1 on a
        # card).
        hyp = generate_hypotheses(f1, f2, params, caps)
    with record_function("cluster"):
        reps = cluster_hypotheses(hyp, params, caps)

    # Quick verify every representative (P x 3 types x C reps).
    with record_function("quick_verify"):
        rep_T = geometry.make_transform(
            geometry.quat_to_matrix(reps.quat), reps.t
        )
        qs = match_faces(rep_T, f1, f2, params)[0]
        qscore = torch.where(reps.valid, qs, float("-inf"))

    with record_function("select"):
        # Per-type sort by quick score desc (stable), top fine_verify_number.
        K = params.fine_verify_number
        order = torch.sort(-qscore, dim=-1, stable=True).indices
        top_idx = order[..., :K]                                 # (P, 3, K)
        top_valid = torch.gather(reps.valid, -1, top_idx)
        top_T0 = take(rep_T, top_idx)
        top_q = torch.where(top_valid, torch.gather(qscore, -1, top_idx), 0.0)

    # Refine only the (P, 3, K) selected candidates (:772-776).
    with record_function("refine"):
        top_T = refine_transform(top_T0, f1, f2, params)

    # Fine verify: table = target residual, candidates move the source.
    with record_function("fine_verify"):
        _, r_ovf, r_valid, r_pts = compact(
            res_mask, caps.max_residual, res_pts, batch_dims=1
        )
        table = build_source_table(r_pts[:P], r_valid[:P], params, caps)
        fscore, falias = fine_verify(top_T, table, r_pts[P:], r_valid[P:],
                                     params, caps)
        fscore = torch.where(top_valid, fscore, 0.0)
        fine_aliased = torch.any((falias & top_valid).flatten(1), dim=-1)

    with record_function("fuse"):
        # Global score normalization across all fine-verified candidates
        # (:1539-1540), then per-type best by combined score (:1553-1567).
        s1_sum = torch.sum(top_q, dim=(-2, -1))[:, None, None]
        s2_sum = torch.sum(fscore, dim=(-2, -1))[:, None, None]
        combined = torch.where(
            s1_sum > 0, top_q / torch.clamp(s1_sum, min=1e-20), 0.0
        ) + torch.where(s2_sum > 0, fscore / torch.clamp(s2_sum, min=1e-20),
                        0.0)
        combined = torch.where(top_valid, combined, 0.0)

        best_in_type = torch.argmax(combined, dim=-1)  # first max (:1559 >)
        best_score = torch.gather(combined, -1,
                                  best_in_type[..., None])[..., 0]
        best_T = take(top_T, best_in_type[..., None])[:, :, 0]
        best_best = torch.amax(best_score, dim=-1)

        # 0.8 gate (:1600-1605), rotation-consistency gate, weighted fusion.
        keep = best_score > params.fuse_gate * best_best[:, None]
        if params.fuse_rotation_gate_deg > 0:
            best_type = torch.argmax(best_score, dim=-1)
            ref = take(best_T, best_type[:, None])  # (P, 1, 4, 4)
            rel = geometry.rotation_error_deg(best_T[..., :3, :3],
                                              ref[..., :3, :3])
            keep = keep & (rel < params.fuse_rotation_gate_deg)
        quats = geometry.matrix_to_quat(best_T[..., :3, :3])
        T = fuse_transforms(quats, best_T[..., :3, 3], best_score, keep)

        degenerate = best_best <= 0.0
        T = torch.where(degenerate[:, None, None],
                        torch.eye(4, dtype=f32, device=dev), T)

        def bit(flag, value):
            return torch.where(flag, value, 0)

        status = (
            bit(ovf[:P] | ovf[P:], STATUS_VOXEL_OVERFLOW)
            | bit(hyp.overflow, STATUS_HYPOTHESIS_OVERFLOW)
            | bit(degenerate, STATUS_DEGENERATE)
            | bit(reps.overflow, STATUS_REP_OVERFLOW)
            | bit(r_ovf[:P] | r_ovf[P:], STATUS_RESIDUAL_OVERFLOW)
            | bit(table.overflow, STATUS_FINE_OVERFLOW)
            | bit(fine_aliased, STATUS_FINE_ALIAS)
        ).to(torch.int32)

        return RegistrationResult(
            transform=T,
            quick_score=torch.amax(top_q, dim=-1),
            fine_score=torch.amax(fscore, dim=-1),
            n_faces=torch.stack(
                [torch.sum(f1.valid, dim=-1), torch.sum(f2.valid, dim=-1)],
                dim=-1,
            ).to(torch.int32),
            n_hypotheses=hyp.count,
            status=status,
            type_transform=best_T,
            type_score=best_score,
            kept=keep,
        )


def pre_downsample(points, mask, params, caps):
    """CLI-level first voxel-grid pass (FCCF.cpp:1668-1678): a
    raw-capacity cloud (N, 3) + (N,) mask, or a batch of them (P, N, 3)
    + (P, N), in; the compacted ``caps.max_points`` cloud(s) out, on
    the points' device. Returns (pts, mask, overflow), with
    the input's leading pair axis, if any."""
    d, dm, ovf = voxel_grid_downsample(points, mask, params.leaf_size)
    _, ovf2, out_valid, out_pts = compact(dm, caps.max_points, d,
                                          batch_dims=dm.dim() - 1)
    return out_pts, out_valid, ovf | ovf2
