"""The cluster stage's greedy-leader block scan (C1's plain version,
``block_scan``), the intra-block seeds and the adaptive floor walk (C2's
plain version, ``floor_walk``, on the host), on any device. A frozen copy
of the plain versions in ``fccf_pcr_torch/ops/cluster_kernels.py``."""

from __future__ import annotations

import numpy as np
import torch

from . import geometry
from .batch import fold_sum, small_matmul
from .precision import matmul

# The block of the scan (the JAX package's _SEED_BLOCK).
SEED_BLOCK = 512


def ball_rows(t_rows, px_rows, t, px, params):
    """(..., B, H) ball predicates: translation within cluster_dist
    (squared) AND rotation within cluster_angle (angle between Q.x_hat
    images)."""
    cos_gate = geometry.cos_deg(params.cluster_angle)
    r2 = params.cluster_dist * params.cluster_dist
    d2 = (
        torch.sum(t_rows * t_rows, dim=-1)[..., :, None]
        + torch.sum(t * t, dim=-1)[..., None, :]
        - 2.0 * small_matmul(t_rows, t.mT)
    )
    cosm = torch.clamp(small_matmul(px_rows, px.mT), -1.0, 1.0)
    return (d2 <= r2) & (cosm >= cos_gate)


def block_count(last_idx, H, B):
    """The blocks the plain scan visits: all ``H // B`` on a card, up to
    the batch's last occupied one on the CPU (one host read; the same
    bits: a block past every lane's last hypothesis has no valid row or
    column, so it changes no seed and adds only zeros to the member sums,
    whose running total, ``0.0 +`` the first tile, is never -0.0)."""
    if last_idx.is_cuda:
        return H // B
    return (int(torch.amax(last_idx)) + 1 + B - 1) // B


def block_scan_plain(masks, t, px, py, params):
    """The greedy-leader seed sets and per-slot cluster stats in one
    ordered block scan: masks (..., 3, H) bool, t, px, py (..., H, 3).
    Returns (seeds (..., 3, H) bool, size (..., 3, H), sums (..., 3, H,
    9)). Blocks of 512 indices in order; each block's ball predicates are
    computed for its rows, its seeds by ``block_seeds`` on the strictly
    lower (B, B) block, and its rows' member sums (of [t, px, py, 1] over
    the row's ball within the type lane: allocated or not, the
    reference's overlap quirk) as (B, B, 30) product tiles folded with a
    fixed pairwise tree, the tiles added in order."""
    lead = tuple(masks.shape[:-2])
    n_types, H = masks.shape[-2:]
    dev = t.device
    dt = t.dtype
    B = min(SEED_BLOCK, H)
    if H % B:
        raise ValueError(f"max_hypotheses={H} must be a multiple of {B}")
    idx = torch.arange(H, device=dev)
    last_idx = torch.amax(torch.where(masks, idx, -1), dim=-1)
    eligible = masks & (idx != last_idx[..., None])
    bi = torch.arange(B, device=dev)
    lower = bi[:, None] < bi[None, :]  # [j, i] within block
    # Per-type member stats: columns [t, px, py, 1] per type lane, zeroed
    # outside the lane.
    stats10 = torch.cat(
        [t, px, py, torch.ones(lead + (H, 1), dtype=dt, device=dev)], dim=-1
    )
    stats_cols = stats10[..., None, :, :] * masks[..., None].to(dt)
    stats_cols = stats_cols.transpose(-3, -2).reshape(lead + (H, n_types * 10))

    covered = torch.zeros_like(masks)
    seeds = torch.zeros_like(masks)
    size = torch.zeros(masks.shape, dtype=dt, device=dev)
    sums = torch.zeros(masks.shape + (9,), dtype=dt, device=dev)

    n_blocks = block_count(last_idx, H, B)
    for i in range(n_blocks):
        sl = slice(i * B, (i + 1) * B)
        t_rows = t[..., sl, :]
        px_rows = px[..., sl, :]
        mask_rows = masks[..., sl]
        elig_b = (eligible & ~covered)[..., sl]

        geo = ball_rows(t_rows, px_rows, t, px, params)  # (..., B, H)
        geo_f = geo.to(dt)
        sub = (geo[..., None, :, sl] & mask_rows[..., :, None]
               & mask_rows[..., None, :])
        sub_lower = sub & lower

        s = block_seeds(sub_lower, elig_b)

        s_eff = (s & mask_rows).to(dt)  # (..., 3, B)
        # (..., 3, H) seed-ball hit counts: small integers, exact in any
        # order of additions.
        cov_hits = matmul(s_eff, geo_f)
        covered = covered | ((cov_hits > 0.5) & masks)
        # (..., B, 3*10) member sums: a fixed pairwise tree inside each
        # column tile of B, the tiles added in order, up to the last
        # block scanned (past the batch's last occupied column every
        # column is zero).
        ss = 0.0
        for j in range(n_blocks):
            cl = slice(j * B, (j + 1) * B)
            ss = ss + fold_sum(geo_f[..., :, cl, None]
                               * stats_cols[..., None, cl, :], dim=-2)
        ss = ss.reshape(lead + (B, n_types, 10)).transpose(-3, -2)
        ss = ss * mask_rows[..., None].to(dt)
        seeds[..., sl] = s
        size[..., sl] = ss[..., 9]
        sums[..., sl, :] = ss[..., 0:9]
    return seeds, size, sums


def block_seeds_plain(sub_lower, elig):
    """The seeds of one block by the JAX package's fixpoint: s <- elig AND
    NOT any(j: s[j] AND sub_lower[j, i]), from s = elig, until no lane
    changes (at most B rounds). sub_lower (..., B, B) and elig (..., B)
    bool; returns (..., B) bool."""
    s = elig
    for _ in range(elig.shape[-1]):
        new = elig & ~torch.any(sub_lower & s[..., :, None], dim=-2)
        changed = bool(torch.any(new != s))
        s = new
        if not changed:
            break
    return s


def _walk_lane(sizes, cn):
    """The floor walk of one lane over its sorted sizes (Python floats;
    integer counts, so float32 and Python floats compare alike): the
    emitted slots and the number of slots walked before it stopped."""
    emitted = []
    floor = max(sizes[0], 0.0)
    for i, size in enumerate(sizes):
        if not size > 0.0:
            continue
        if size >= floor:
            emitted.append(i)
            if len(emitted) > cn:  # break after push (:1208-1211)
                return emitted, i + 1
        elif len(emitted) < cn / 2.0:
            floor -= 1.0
            if floor < 2.0:
                return emitted, i + 1
        else:
            return emitted, i + 1
    return emitted, len(sizes)


def floor_walk_plain(s_size, cluster_num):
    """The adaptive floor walk over clusters sorted by size (:1126-1229)
    of every lane, on the host: s_size (..., W) (a slot is a seed cluster
    iff its size is > 0), cluster_num (...). Returns the (..., W) emit
    mask on s_size's device."""
    W = s_size.shape[-1]
    host = torch.cat([s_size, cluster_num[..., None].to(s_size.dtype)],
                     dim=-1).reshape(-1, W + 1).cpu().tolist()
    emit = np.zeros((len(host), W), bool)
    for lane, row in enumerate(host):
        emit[lane, _walk_lane(row[:W], row[W])[0]] = True
    return torch.from_numpy(emit).to(s_size.device).reshape(s_size.shape)


block_seeds = block_seeds_plain
block_scan = block_scan_plain
floor_walk = floor_walk_plain
