"""The cluster stage's sequential loops, each as a CUDA kernel and its
plain PyTorch version.

  - ``block_scan`` (C1): the whole greedy-leader block scan, the seeds
    and the member sums of every hypothesis, the JAX package's loop over
    blocks with its intra-block ``lax.while_loop`` and its member-sum
    product (``fccf_pcr_tpu/cluster/cluster.py:131-200``), one launch
    for every block;
  - ``block_seeds``: the greedy seeds of one block alone (the
    ``lax.while_loop`` at ``:151-161``), given its predicate block; the
    walk C1 runs inside, kept as a standalone entry off the main path;
  - ``floor_walk`` (C2): the adaptive floor walk's emit mask, the JAX
    package's ``lax.scan`` (``fccf_pcr_tpu/cluster/cluster.py:241-262``).

CUDA tensors take the kernels of ``csrc/cluster.cu``, which run on the
card with no host sync; there is no fallback: a missing ``nvcc``, a
failed build or a refused launch raises. CPU tensors take the plain
versions (``block_scan_plain``: the block loop in PyTorch, with
``block_seeds`` inside and the member sums as (B, B, 30) product tiles
folded by ``fold_sum``; ``block_seeds_plain``: the fixpoint iterated
until no lane changes, one host read a round; ``floor_walk_plain``: the
walk in Python over every lane, one transfer each way). Any other
device raises.

The library is built with nvcc into ``fccf_pcr_torch/build/`` at first
use and bound with ctypes (``ops.cuda_build``). ``SCANS``, ``SEEDS`` and
``WALKS`` count the kernels' launches (``ops.graph.count_launch``: a
launch captured into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
from torch.profiler import record_function

from . import geometry, graph
from .batch import fold_sum, small_matmul
from .cuda_build import CudaLibrary

# Launches of cluster_block_scan (C1), of the standalone cluster_block_seeds
# and of cluster_floor_walk (C2).
SCANS = 0
SEEDS = 0
WALKS = 0
_THIS = sys.modules[__name__]
# The largest block the kernels take (csrc/cluster.cu: kMaxBlock), and the
# block of the scan (the JAX package's _SEED_BLOCK).
MAX_BLOCK = 512
SEED_BLOCK = 512


def _bind(lib):
    for name in ("fccf_cluster_block_seeds", "fccf_cluster_floor_walk"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.fccf_cluster_block_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("cluster.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/cluster.cu`` (if needed, or always with ``force``)
    and load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# ---------------------------------------------------------------- plain --


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
        cov_hits = s_eff @ geo_f
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


# -------------------------------------------------------------- kernels --


def _check(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(entry, counter, inputs, out, L, n):
    """One launch of ``entry`` on the current stream, asynchronously."""
    lib = build()
    dev = out.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = getattr(lib, entry)(*(t.data_ptr() for t in inputs),
                                 out.data_ptr(), L, n, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, counter)


def _launch_block_seeds(sub_lower, elig):
    lead, B = tuple(elig.shape[:-1]), elig.shape[-1]
    if not 0 < B <= MAX_BLOCK:
        raise ValueError(f"block_seeds: block of {B}, want 1..{MAX_BLOCK}")
    _check(elig, "elig", torch.bool, lead + (B,), elig.device)
    _check(sub_lower, "sub_lower", torch.bool, lead + (B, B), elig.device)
    L = int(np.prod(lead, dtype=np.int64))
    out = torch.empty_like(elig)
    if L:
        _launch("fccf_cluster_block_seeds", "SEEDS",
                (sub_lower.contiguous(), elig.contiguous()), out, L, B)
    return out


def _launch_block_scan(masks, t, px, py, params):
    lead, H = tuple(masks.shape[:-2]), masks.shape[-1]
    B = min(SEED_BLOCK, H)
    if H % B:
        raise ValueError(f"max_hypotheses={H} must be a multiple of {B}")
    dev = masks.device
    _check(masks, "masks", torch.bool, lead + (3, H), dev)
    for name, x in (("t", t), ("px", px), ("py", py)):
        _check(x, name, torch.float32, lead + (H, 3), dev)
    P = int(np.prod(lead, dtype=np.int64))
    seeds = torch.empty(masks.shape, dtype=torch.bool, device=dev)
    size = torch.empty(masks.shape, dtype=torch.float32, device=dev)
    sums = torch.empty(masks.shape + (9,), dtype=torch.float32, device=dev)
    if P == 0 or H == 0:
        return seeds, size, sums
    # The gates as the plain version's comparisons take them: float32.
    r2 = float(np.float32(params.cluster_dist * params.cluster_dist))
    cos_gate = geometry.cos_deg(params.cluster_angle)
    inputs = [x.contiguous() for x in (masks, t, px, py)]
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = lib.fccf_cluster_block_scan(
            *(x.data_ptr() for x in inputs), seeds.data_ptr(),
            size.data_ptr(), sums.data_ptr(), P, H, B, r2, cos_gate, stream)
    if rc != 0:
        raise RuntimeError(
            f"fccf_cluster_block_scan launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, "SCANS")
    return seeds, size, sums


def _launch_floor_walk(s_size, cluster_num):
    lead, W = tuple(s_size.shape[:-1]), s_size.shape[-1]
    _check(s_size, "s_size", torch.float32, lead + (W,), s_size.device)
    _check(cluster_num, "cluster_num", torch.float32, lead, s_size.device)
    L = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(s_size.shape, dtype=torch.bool, device=s_size.device)
    if L and W:
        _launch("fccf_cluster_floor_walk", "WALKS",
                (s_size.contiguous(), cluster_num.contiguous()), out, L, W)
    else:
        out.zero_()
    return out


def block_seeds(sub_lower, elig):
    """The greedy seeds of one block of every lane: sub_lower (..., B, B)
    bool, strictly lower triangular ([j, i] only for j < i: seed j's ball
    holds i), elig (..., B) bool. Returns (..., B) bool s, the one
    solution of s[i] = elig[i] AND NOT any(j < i: s[j] AND
    sub_lower[j, i]). CPU tensors take the plain version, CUDA tensors
    the kernel C1; any other device raises."""
    if elig.device.type == "cpu":
        return block_seeds_plain(sub_lower, elig)
    if elig.device.type == "cuda":
        return _launch_block_seeds(sub_lower, elig)
    raise ValueError(f"block_seeds: unsupported device {elig.device}")


def block_scan(masks, t, px, py, params):
    """The greedy-leader block scan of every (..., type) lane: masks
    (..., 3, H) bool, t, px, py (..., H, 3) float32, ``params`` with
    cluster_dist and cluster_angle. Returns (seeds (..., 3, H) bool, size
    (..., 3, H), sums (..., 3, H, 9)), see ``block_scan_plain``. CPU
    tensors take the plain version, CUDA tensors the kernel C1 (one
    launch, no host sync); any other device raises."""
    with record_function("block_scan"):
        if masks.device.type == "cpu":
            return block_scan_plain(masks, t, px, py, params)
        if masks.device.type == "cuda":
            return _launch_block_scan(masks, t, px, py, params)
        raise ValueError(f"block_scan: unsupported device {masks.device}")


def floor_walk(s_size, cluster_num):
    """The floor walk's emit mask (..., W) bool over s_size (..., W)
    float32 sorted by size descending, with the budgets cluster_num (...)
    float32. CPU tensors take the plain version, CUDA tensors the kernel
    C2; any other device raises."""
    with record_function("floor_walk"):
        if s_size.device.type == "cpu":
            return floor_walk_plain(s_size, cluster_num)
        if s_size.device.type == "cuda":
            return _launch_floor_walk(s_size, cluster_num)
        raise ValueError(f"floor_walk: unsupported device {s_size.device}")
