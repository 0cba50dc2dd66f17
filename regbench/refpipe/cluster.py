"""Transform-hypothesis clustering (port of
``fccf_pcr_tpu/cluster/cluster.py``; ``transform_cluster``
FCCF.cpp:1040-1231).

Reference semantics are kept exactly, as in the JAX package:

  - <= 10 hypotheses of a type pass through unclustered; 0 -> one
    identity representative (:1043-1063);
  - otherwise greedy leader clustering: index i is a seed iff it is
    eligible (valid, not the type's last index) and no earlier seed's
    ball covers it. Blocks of 512 indices are scanned in order (the
    block scan, ``ops.cluster_kernels.block_scan``). Members of a seed's
    cluster are its whole ball within the type (allocated or not, the
    reference's overlap quirk);
  - clusters sorted by size desc (stable), then emitted with the adaptive
    floor walk (:1126-1229), each representative being the mean
    translation and the axis-averaged rotation of its members.

Every function takes leading batch dims (a pair axis), and the three
types are one more lane axis, and both branches of the <= 10 test are
computed and selected per lane, as under the JAX package's ``jax.vmap``.
On a card the block scan is one launch of the kernel C1 whatever
``H // 512`` is, as the register step's CUDA graph needs (a fixed
launch count, and the eager warm-up before a capture runs the same
launch as the capture). On the CPU its plain version stops at the
batch's last occupied block, as the JAX package's does (one host read):
the same bits.

Host syncs: none on a card, where the block scan and the floor walk are
``ops.cluster_kernels``' kernels C1 and C2; on the CPU their plain
versions read back to the host (one read a fixpoint round, and the walk
over every lane with one transfer each way).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import Capacities, FCCFParams
from .transforms import Hypotheses
from . import geometry
from .batch import constant, take
from .cluster_kernels import block_scan, floor_walk
from .voxelize import compact


class Representatives(NamedTuple):
    """Per-type cluster representatives (type-major lane axis after the
    leading batch dims)."""

    quat: torch.Tensor      # (..., 3, C, 4)
    t: torch.Tensor         # (..., 3, C, 3)
    valid: torch.Tensor     # (..., 3, C) bool
    overflow: torch.Tensor  # (...) bool, any type's seed/rep capacity exceeded


def _greedy_seeds_all_types(masks, t, px, py, params):
    """Exact greedy-leader seed sets + per-slot cluster stats in one
    ordered block scan: masks (..., 3, H), t, px, py (..., H, 3). Returns
    (seeds (..., 3, H), size (..., 3, H), sums (..., 3, H, 9)): the
    kernel C1 on a card (one launch), its plain version on the CPU
    (``ops.cluster_kernels.block_scan``)."""
    return block_scan(masks, t, px, py, params)


def _emit_representatives(seed_valid, size, sums, cluster_num, caps):
    """Sorted emission with the floor walk over the selected seed
    clusters (size desc, index asc) of every lane, then
    per-representative poses for the emitted slots only."""
    key = torch.where(seed_valid, size, -1.0)
    order = torch.sort(-key, dim=-1, stable=True).indices
    s_size = take(size, order)
    s_sums = take(sums, order)
    emit = floor_walk(s_size, cluster_num)

    C = caps.max_reps
    _, overflow, r_valid, r_size, r_sums = compact(
        emit, C, s_size, s_sums, batch_dims=emit.dim() - 1
    )
    mean_t = r_sums[..., 0:3] / torch.clamp(r_size[..., None], min=1.0)
    nt1 = geometry.normalize(r_sums[..., 3:6])
    nt2 = geometry.normalize(r_sums[..., 6:9])
    R = geometry.rotation_from_two_axes(nt1, nt2)
    q = geometry.matrix_to_quat(R)
    q = torch.where(r_valid[..., None], q, 0.0)
    mean_t = torch.where(r_valid[..., None], mean_t, 0.0)
    return r_valid, q, mean_t, overflow


def _cluster_types(type_mask, hyp, is_seed, size_all, sums_all, cluster_num,
                   params, caps):
    """Representatives of every (..., type) lane: type_mask, is_seed,
    size_all (..., 3, H), sums_all (..., 3, H, 9), cluster_num (..., 3).
    Both branches of the lane's count test are computed, then selected."""
    C = caps.max_reps
    W = caps.max_clusters
    dev = type_mask.device
    lanes = tuple(type_mask.shape[:-1])
    count = torch.sum(type_mask, dim=-1)

    # Branch 1: pass-through (<= 10) / identity (0) (:1043-1063).
    H = type_mask.shape[-1]
    _, _, p_valid, p_q, p_t = compact(
        type_mask, C, hyp.quat[..., None, :, :].expand(lanes + (H, 4)),
        hyp.t[..., None, :, :].expand(lanes + (H, 3)),
        batch_dims=len(lanes),
    )
    first = torch.arange(C, device=dev) == 0
    empty = (count == 0)[..., None]
    small_valid = torch.where(empty, first, p_valid)
    small_q = torch.where(empty[..., None], 0.0, p_q)
    small_q[..., 0] = torch.where(empty & first, 1.0, small_q[..., 0])
    small_t = torch.where(empty[..., None], 0.0, p_t)

    # Branch 2: keep the top-W seed clusters BY SIZE, ties in hypothesis
    # order (lax.top_k's lowest-index-first, here a stable descending
    # sort). Overflow fires only when an emittable (size >= 2) seed is
    # dropped.
    key = torch.where(is_seed, size_all, -1.0)
    top = torch.sort(key, dim=-1, descending=True, stable=True)
    top_size = top.values[..., : min(W, H)]
    top_idx = top.indices[..., : min(W, H)]
    seed_valid = top_size > 0.0
    size = torch.where(seed_valid, top_size, 0.0)
    sums = take(sums_all, top_idx)
    w_overflow = torch.sum((size_all >= 2.0) & is_seed, dim=-1) > W
    g_valid, g_q, g_t, overflow = _emit_representatives(
        seed_valid, size, sums, cluster_num, caps
    )

    use_small = count <= params.cluster_count_threshold
    valid = torch.where(use_small[..., None], small_valid, g_valid)
    q = torch.where(use_small[..., None, None], small_q, g_q)
    t = torch.where(use_small[..., None, None], small_t, g_t)
    return valid, q, t, (overflow | w_overflow) & ~use_small


def cluster_hypotheses(hyp: Hypotheses, params: FCCFParams,
                       caps: Capacities) -> Representatives:
    """Cluster the hypothesis pool of each pair of the leading batch dims
    per roughness type (call site :1437-1466); cluster budget per type
    int(200 * count / total)."""
    dev = hyp.t.device
    dt = hyp.t.dtype
    xhat = constant((1.0, 0.0, 0.0), dt, dev)
    yhat = constant((0.0, 1.0, 0.0), dt, dev)
    px = geometry.quat_rotate(hyp.quat, xhat.expand(hyp.t.shape))
    py = geometry.quat_rotate(hyp.quat, yhat.expand(hyp.t.shape))

    types = torch.arange(3, dtype=hyp.type_.dtype, device=dev)
    masks = hyp.valid[..., None, :] & (hyp.type_[..., None, :] == types[:, None])
    counts = torch.sum(masks, dim=-1).to(torch.float32)
    total = torch.clamp(torch.sum(counts, dim=-1, keepdim=True), min=1.0)
    cluster_nums = torch.floor(
        float(params.select_cluster_number) * counts / total
    )

    seeds, size_all, sums_all = _greedy_seeds_all_types(
        masks, hyp.t, px, py, params
    )
    valid, q, t, ovf = _cluster_types(
        masks, hyp, seeds, size_all, sums_all, cluster_nums, params, caps
    )
    return Representatives(quat=q, t=t, valid=valid,
                           overflow=torch.any(ovf, dim=-1))
