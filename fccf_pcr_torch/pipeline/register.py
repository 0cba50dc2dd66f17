"""End-to-end scan-pair registration — the pipeline entry (port of
``fccf_pcr_tpu/pipeline/register.py``; ``computer_transform_guess``
FCCF.cpp:1370-1608).

``register_pair(src, tar)`` returns T mapping the SOURCE cloud into the
TARGET frame; internally the target plays the reference's ``face_vecter1``
role and the source ``face_vecter2``, as at its call site (FCCF.cpp:1683).

Stage map:
  NaN removal + downsample/voxelize       -> ops.voxelize (fused, or
                                             downsample + voxel_stats)
  face extraction x2                      -> features.faces (+ ops.label_prop)
  bases + closed-form hypotheses          -> hypotheses
  per-type clustering                     -> cluster
  quick verify + LM refine of the top-K   -> verify.quick, refine
  fine verify of the top-K per type       -> verify.fine
  combined score, 0.8 + rotation gates    -> fuse

The per-pair function takes one pair. The JAX package's inner vmaps are
batch dimensions here: quick verify over (3, C) representatives, refine
over (3, K) and fine verify over 3K candidates. ``make_register_fn(...,
batched=True)`` loops over the pairs of a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..cluster.cluster import cluster_hypotheses
from ..config import Capacities, FCCFParams
from ..features.faces import extract_faces, faces_from_voxels
from ..fuse.fuse import fuse_transforms
from ..hypotheses.bases import select_bases
from ..hypotheses.transforms import generate_hypotheses
from ..ops import geometry
from ..ops.voxelize import compact, downsample_and_voxelize, voxel_grid_downsample
from ..verify.fine import build_source_table, fine_verify
from ..verify.quick import match_faces, refine_transform

STATUS_OK = 0
STATUS_VOXEL_OVERFLOW = 1
STATUS_HYPOTHESIS_OVERFLOW = 2
STATUS_DEGENERATE = 4  # no type scored > 0: identity returned
STATUS_REP_OVERFLOW = 8
STATUS_RESIDUAL_OVERFLOW = 16
STATUS_FINE_OVERFLOW = 32  # fine-verify table (target residual) overflow
STATUS_FINE_ALIAS = 64     # fine-verify table span > 1024 cells/axis


class RegistrationResult(NamedTuple):
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


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def resolve_device(device, like=None) -> torch.device:
    """The device an entry point runs on. Every entry point defaults to
    ``"cuda"``; ``device=None`` keeps the device of a tensor ``like`` (and
    takes ``"cuda"`` for anything else). A CUDA device without a card
    raises: the port never falls back to the CPU, which runs only when it
    is asked for (``device="cpu"``, as the CPU tests do)."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fccf_pcr_torch runs on a CUDA card by default, and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU"
        )
    return dev


def register_pair(src_pts, src_mask, tar_pts, tar_mask, params: FCCFParams,
                  caps: Capacities, device="cuda") -> RegistrationResult:
    """Register one masked pair of clouds: (N, 3) points + (N,) masks,
    numpy arrays or tensors, already voxel-grid downsampled once by the
    caller (``pre_downsample``). Runs on ``device`` (``resolve_device``:
    the card by default, the points' own device with ``None``)."""
    set_precision()
    dev = resolve_device(device, src_pts)
    src_pts = _as_tensor(src_pts, torch.float32, dev)
    tar_pts = _as_tensor(tar_pts, torch.float32, dev)
    src_mask = _as_tensor(src_mask, torch.bool, dev)
    tar_mask = _as_tensor(tar_mask, torch.bool, dev)
    return _register_pair_impl(src_pts, src_mask, tar_pts, tar_mask, params, caps)


def _register_pair_impl(src_pts, src_mask, tar_pts, tar_mask, params, caps):
    dev = src_pts.device
    f32 = src_pts.dtype
    # The downsample fuses with the feature voxelization (one sort per
    # cloud) when the leaf nests integrally in the feature voxel.
    ratio = params.face_voxel_size / params.leaf_size
    fused = abs(ratio - round(ratio)) < 1e-9 * max(ratio, 1.0)

    # NaN removal (:1372-1375).
    with record_function("downsample"):
        src_mask = src_mask & torch.all(torch.isfinite(src_pts), dim=-1)
        tar_mask = tar_mask & torch.all(torch.isfinite(tar_pts), dim=-1)
        src_pts = torch.where(src_mask[:, None], src_pts, 0.0)
        tar_pts = torch.where(tar_mask[:, None], tar_pts, 0.0)

    def cloud_to_faces(pts, msk):
        if not fused:
            d, dm, d_ovf = voxel_grid_downsample(pts, msk, params.leaf_size)
            faces, residual, f_ovf = extract_faces(d, dm, params, caps)
            return faces, residual, f_ovf | d_ovf
        d, _, vs, pv, vstart = downsample_and_voxelize(
            pts, msk, params.leaf_size, params.face_voxel_size,
            caps.max_voxels, wide_extent=caps.wide_extent,
        )
        return faces_from_voxels(vs, d, pv, params, caps, voxel_start=vstart)

    # Faces: f1 = target cloud (reference's face_vecter1), f2 = source.
    with record_function("faces"):
        f1, (res1_pts, res1_mask), ovf1 = cloud_to_faces(tar_pts, tar_mask)
        f2, (res2_pts, res2_mask), ovf2 = cloud_to_faces(src_pts, src_mask)

    with record_function("hypotheses"):
        b1 = select_bases(f1, params)
        b2 = select_bases(f2, params)
        hyp = generate_hypotheses(f1, f2, b1, b2, params, caps)
    with record_function("cluster"):
        reps = cluster_hypotheses(hyp, params, caps)

    # Quick verify every representative (3 types x C reps).
    with record_function("quick_verify"):
        rep_T = geometry.make_transform(
            geometry.quat_to_matrix(reps.quat), reps.t
        )
        qs = match_faces(rep_T, f1, f2, params)[0]
        qscore = torch.where(reps.valid, qs, float("-inf"))

    # Per-type sort by quick score desc (stable), top fine_verify_number.
    K = params.fine_verify_number
    order = torch.sort(-qscore, dim=1, stable=True).indices
    top_idx = order[:, :K]                                   # (3, K)
    rows = torch.arange(3, device=dev)[:, None]
    top_valid = reps.valid[rows, top_idx]
    top_T0 = rep_T[rows, top_idx]
    top_q = torch.where(top_valid, qscore[rows, top_idx], 0.0)

    # Refine only the (3, K) selected candidates (:772-776).
    with record_function("refine"):
        top_T = refine_transform(top_T0, f1, f2, params)

    # Fine verify: table = target residual, candidates move the source.
    with record_function("fine_verify"):
        _, r1_ovf, r1_valid, r1_pts = compact(
            res1_mask, caps.max_residual, res1_pts
        )
        _, r2_ovf, r2_valid, r2_pts = compact(
            res2_mask, caps.max_residual, res2_pts
        )
        table = build_source_table(r1_pts, r1_valid, params, caps)
        fscore_flat, falias_flat = fine_verify(
            top_T.reshape(3 * K, 4, 4), table, r2_pts, r2_valid, params, caps
        )
        fscore = torch.where(top_valid, fscore_flat.reshape(3, K), 0.0)
        fine_aliased = torch.any(falias_flat.reshape(3, K) & top_valid)

    # Global score normalization across all fine-verified candidates
    # (:1539-1540), then per-type best by combined score (:1553-1567).
    s1_sum = torch.sum(top_q)
    s2_sum = torch.sum(fscore)
    combined = torch.where(
        s1_sum > 0, top_q / torch.clamp(s1_sum, min=1e-20), 0.0
    ) + torch.where(s2_sum > 0, fscore / torch.clamp(s2_sum, min=1e-20), 0.0)
    combined = torch.where(top_valid, combined, 0.0)

    best_in_type = torch.argmax(combined, dim=1)  # first max (:1559 >)
    type_rows = torch.arange(3, device=dev)
    best_score = combined[type_rows, best_in_type]
    best_T = top_T[type_rows, best_in_type]
    best_best = torch.amax(best_score)

    # 0.8 gate (:1600-1605), rotation-consistency gate, weighted fusion.
    keep = best_score > params.fuse_gate * best_best
    if params.fuse_rotation_gate_deg > 0:
        best_type = torch.argmax(best_score)
        rel = geometry.rotation_error_deg(
            best_T[:, :3, :3], best_T[best_type, :3, :3][None]
        )
        keep = keep & (rel < params.fuse_rotation_gate_deg)
    quats = geometry.matrix_to_quat(best_T[:, :3, :3])
    T = fuse_transforms(quats, best_T[:, :3, 3], best_score, keep)

    degenerate = best_best <= 0.0
    T = torch.where(degenerate, torch.eye(4, dtype=f32, device=dev), T)

    def bit(flag, value):
        return torch.where(flag, value, 0)

    status = (
        bit(ovf1 | ovf2, STATUS_VOXEL_OVERFLOW)
        | bit(hyp.overflow, STATUS_HYPOTHESIS_OVERFLOW)
        | bit(degenerate, STATUS_DEGENERATE)
        | bit(reps.overflow, STATUS_REP_OVERFLOW)
        | bit(r1_ovf | r2_ovf, STATUS_RESIDUAL_OVERFLOW)
        | bit(table.overflow, STATUS_FINE_OVERFLOW)
        | bit(fine_aliased, STATUS_FINE_ALIAS)
    ).to(torch.int32)

    return RegistrationResult(
        transform=T,
        quick_score=torch.amax(top_q, dim=1),
        fine_score=torch.amax(fscore, dim=1),
        n_faces=torch.stack(
            [torch.sum(f1.valid), torch.sum(f2.valid)]
        ).to(torch.int32),
        n_hypotheses=hyp.count,
        status=status,
        type_transform=best_T,
        type_score=best_score,
        kept=keep,
    )


def pre_downsample(points, mask, params: FCCFParams, caps: Capacities,
                   device="cuda"):
    """CLI-level first voxel-grid pass (FCCF.cpp:1668-1678): a
    raw-capacity cloud in, the compacted ``caps.max_points`` cloud out, on
    ``device`` (``resolve_device``). Returns (pts, mask, overflow)."""
    dev = resolve_device(device, points)
    points = _as_tensor(points, torch.float32, dev)
    mask = _as_tensor(mask, torch.bool, dev)
    d, dm, ovf = voxel_grid_downsample(points, mask, params.leaf_size)
    _, ovf2, out_valid, out_pts = compact(dm, caps.max_points, d)
    return out_pts, out_valid, ovf | ovf2


def make_register_fn(params: FCCFParams, caps: Capacities,
                     batched: bool = False, device="cuda"):
    """Registration function with fixed params/capacities on ``device``
    (``resolve_device``: the card by default, which is checked here, so
    that a missing card raises before any pair is registered).

    batched=False: (src (N,3), src_mask, tar (N,3), tar_mask) -> result
    batched=True:  a leading pair axis on every argument; the pairs are
    registered one after another and the results stacked.
    """
    if device is not None:
        device = resolve_device(device)

    def fn(src, src_mask, tar, tar_mask):
        return register_pair(
            src, src_mask, tar, tar_mask, params, caps, device=device
        )

    if not batched:
        return fn

    def fn_batched(src, src_mask, tar, tar_mask):
        results = [
            fn(src[b], src_mask[b], tar[b], tar_mask[b])
            for b in range(len(src))
        ]
        return RegistrationResult(*(torch.stack(f) for f in zip(*results)))

    return fn_batched
