"""Transform-hypothesis clustering (port of
``fccf_pcr_tpu/cluster/cluster.py``; ``transform_cluster``
FCCF.cpp:1040-1231).

Reference semantics are kept exactly, as in the JAX package:

  - <= 10 hypotheses of a type pass through unclustered; 0 -> one
    identity representative (:1043-1063);
  - otherwise greedy leader clustering, derived in parallel: index i is a
    seed iff it is eligible (valid, not the type's last index) and no
    earlier seed's ball covers it. Blocks of 512 indices are scanned in
    order; each block's geometric ball predicates are computed for its
    rows only, and intra-block dependencies resolve with a small
    fixpoint. Members of a seed's cluster are its whole ball within the
    type (allocated or not, the reference's overlap quirk);
  - clusters sorted by size desc (stable), then emitted with the adaptive
    floor walk (:1126-1229), each representative being the mean
    translation and the axis-averaged rotation of its members.

Host syncs: the per-block fixpoint tests convergence on the host, and the
floor walk (a short sequential scalar loop) runs on the host; removing
them is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Capacities, FCCFParams
from ..hypotheses.transforms import Hypotheses
from ..ops import geometry
from ..ops.voxelize import compact

_SEED_BLOCK = 512


class Representatives(NamedTuple):
    """Per-type cluster representatives (type-major leading axis)."""

    quat: torch.Tensor      # (3, C, 4)
    t: torch.Tensor         # (3, C, 3)
    valid: torch.Tensor     # (3, C) bool
    overflow: torch.Tensor  # () bool, any type's seed/rep capacity exceeded


def _ball_rows(t_rows, px_rows, t, px, params):
    """(B, H) ball predicates: translation within cluster_dist (squared)
    AND rotation within cluster_angle (angle between Q.x_hat images)."""
    cos_gate = geometry.cos_deg(params.cluster_angle)
    r2 = params.cluster_dist * params.cluster_dist
    d2 = (
        torch.sum(t_rows * t_rows, dim=-1)[:, None]
        + torch.sum(t * t, dim=-1)[None, :]
        - 2.0 * (t_rows @ t.mT)
    )
    cosm = torch.clamp(px_rows @ px.mT, -1.0, 1.0)
    return (d2 <= r2) & (cosm >= cos_gate)


def _greedy_seeds_all_types(masks, t, px, py, params):
    """Exact greedy-leader seed sets + per-slot cluster stats in one
    ordered block scan. Returns (seeds (3, H), size (3, H), sums (3, H, 9))."""
    n_types, H = masks.shape
    dev = t.device
    dt = t.dtype
    B = min(_SEED_BLOCK, H)
    if H % B:
        raise ValueError(f"max_hypotheses={H} must be a multiple of {B}")
    idx = torch.arange(H, device=dev)
    last_idx = torch.amax(torch.where(masks, idx[None, :], -1), dim=1)
    eligible = masks & (idx[None, :] != last_idx[:, None])
    bi = torch.arange(B, device=dev)
    lower = bi[:, None] < bi[None, :]  # [j, i] within block
    # Per-type member stats as ONE matmul: columns [t, px, py, 1] per type
    # lane, zeroed outside the lane.
    stats10 = torch.cat(
        [t, px, py, torch.ones((H, 1), dtype=dt, device=dev)], dim=-1
    )
    stats_cols = stats10[None] * masks[:, :, None].to(dt)  # (3, H, 10)
    stats_cols = stats_cols.permute(1, 0, 2).reshape(H, n_types * 10)

    covered = torch.zeros((n_types, H), dtype=torch.bool, device=dev)
    seeds = torch.zeros((n_types, H), dtype=torch.bool, device=dev)
    size = torch.zeros((n_types, H), dtype=dt, device=dev)
    sums = torch.zeros((n_types, H, 9), dtype=dt, device=dev)

    # Blocks past the last valid index hold no valid rows or columns.
    n_blocks = (int(torch.amax(last_idx)) + 1 + B - 1) // B
    for i in range(n_blocks):
        sl = slice(i * B, (i + 1) * B)
        t_rows = t[sl]
        px_rows = px[sl]
        mask_rows = masks[:, sl]
        elig_b = (eligible & ~covered)[:, sl]

        geo = _ball_rows(t_rows, px_rows, t, px, params)  # (B, H)
        geo_f = geo.to(dt)
        sub = geo[None, :, sl] & mask_rows[:, :, None] & mask_rows[:, None, :]
        sub_lower = sub & lower[None]

        s = elig_b
        for _ in range(B):
            cov_in = torch.any(sub_lower & s[:, :, None], dim=1)
            new = elig_b & ~cov_in
            changed = bool(torch.any(new != s))
            s = new
            if not changed:
                break

        s_eff = (s & mask_rows).to(dt)  # (3, B)
        cov_hits = s_eff @ geo_f        # (3, H) seed-ball hit counts
        covered = covered | ((cov_hits > 0.5) & masks)
        ss = geo_f @ stats_cols         # (B, 3*10)
        ss = ss.reshape(B, n_types, 10).permute(1, 0, 2)
        ss = ss * mask_rows[:, :, None].to(dt)
        seeds[:, sl] = s
        size[:, sl] = ss[..., 9]
        sums[:, sl] = ss[..., 0:9]
    return seeds, size, sums


def _floor_walk(s_seed, s_size, cluster_num):
    """The adaptive floor walk over clusters sorted by size (:1126-1229),
    on the host. Returns the emit mask."""
    seed = s_seed.cpu().numpy()
    size = s_size.cpu().numpy().astype(np.float32)
    emit = np.zeros(seed.shape, bool)
    emitted = 0
    floor = np.float32(max(size[0], 0.0))
    for i in range(seed.shape[0]):
        if not seed[i]:
            continue
        if size[i] >= floor:
            emit[i] = True
            emitted += 1
            if emitted > cluster_num:  # break after push (:1208-1211)
                break
        elif emitted < cluster_num / 2.0:
            floor = np.float32(floor - 1.0)
            if floor < 2.0:
                break
        else:
            break
    return torch.from_numpy(emit).to(s_seed.device)


def _emit_representatives(seed_valid, size, sums, cluster_num, caps):
    """Sorted emission with the floor walk over the selected seed
    clusters (size desc, index asc), then per-representative poses for
    the emitted slots only."""
    key = torch.where(seed_valid, size, -1.0)
    order = torch.sort(-key, stable=True).indices
    s_seed = seed_valid[order]
    s_size = size[order]
    s_sums = sums[order]
    emit = _floor_walk(s_seed, s_size, cluster_num)

    C = caps.max_reps
    _, overflow, r_valid, r_size, r_sums = compact(emit, C, s_size, s_sums)
    mean_t = r_sums[:, 0:3] / torch.clamp(r_size[:, None], min=1.0)
    nt1 = geometry.normalize(r_sums[:, 3:6])
    nt2 = geometry.normalize(r_sums[:, 6:9])
    R = geometry.rotation_from_two_axes(nt1, nt2)
    q = geometry.matrix_to_quat(R)
    q = torch.where(r_valid[:, None], q, 0.0)
    mean_t = torch.where(r_valid[:, None], mean_t, 0.0)
    return r_valid, q, mean_t, overflow


def _cluster_one_type(type_mask, hyp, is_seed, size_all, sums_all,
                      cluster_num, params, caps):
    C = caps.max_reps
    W = caps.max_clusters
    dev = type_mask.device
    count = int(torch.sum(type_mask))

    if count <= params.cluster_count_threshold:
        # Pass-through (<= 10) / identity (0) (:1043-1063).
        if count == 0:
            valid = torch.zeros((C,), dtype=torch.bool, device=dev)
            valid[0] = True
            q = torch.zeros((C, 4), dtype=hyp.quat.dtype, device=dev)
            q[0, 0] = 1.0
            t = torch.zeros((C, 3), dtype=hyp.t.dtype, device=dev)
        else:
            _, _, valid, q, t = compact(type_mask, C, hyp.quat, hyp.t)
        return valid, q, t, torch.zeros((), dtype=torch.bool, device=dev)

    # Keep the top-W seed clusters BY SIZE, ties in hypothesis order
    # (lax.top_k's lowest-index-first, here a stable descending sort).
    # Overflow fires only when an emittable (size >= 2) seed is dropped.
    key = torch.where(is_seed, size_all, -1.0)
    top = torch.sort(key, descending=True, stable=True)
    top_size = top.values[: min(W, key.shape[0])]
    top_idx = top.indices[: min(W, key.shape[0])]
    seed_valid = top_size > 0.0
    size = torch.where(seed_valid, top_size, 0.0)
    sums = sums_all[top_idx]
    w_overflow = torch.sum((size_all >= 2.0) & is_seed) > W
    valid, q, t, overflow = _emit_representatives(
        seed_valid, size, sums, cluster_num, caps
    )
    return valid, q, t, overflow | w_overflow


def cluster_hypotheses(hyp: Hypotheses, params: FCCFParams,
                       caps: Capacities) -> Representatives:
    """Cluster the hypothesis pool per roughness type (call site
    :1437-1466); cluster budget per type int(200 * count / total)."""
    H = hyp.valid.shape[0]
    dev = hyp.t.device
    dt = hyp.t.dtype
    xhat = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev).expand(H, 3)
    yhat = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev).expand(H, 3)
    px = geometry.quat_rotate(hyp.quat, xhat)
    py = geometry.quat_rotate(hyp.quat, yhat)

    types = torch.arange(3, dtype=hyp.type_.dtype, device=dev)
    masks = hyp.valid[None, :] & (hyp.type_[None, :] == types[:, None])
    counts = torch.sum(masks, dim=1).to(torch.float32)
    total = torch.clamp(torch.sum(counts), min=1.0)
    cluster_nums = torch.floor(
        float(params.select_cluster_number) * counts / total
    ).cpu().tolist()

    seeds, size_all, sums_all = _greedy_seeds_all_types(
        masks, hyp.t, px, py, params
    )
    out = [
        _cluster_one_type(
            masks[ty], hyp, seeds[ty], size_all[ty], sums_all[ty],
            cluster_nums[ty], params, caps,
        )
        for ty in range(3)
    ]
    valid, q, t, ovf = (torch.stack(x) for x in zip(*out))
    return Representatives(quat=q, t=t, valid=valid, overflow=torch.any(ovf))
