"""Automatic capacity sizing from the actual input clouds (a jax-free
copy of ``fccf_pcr_tpu/models/auto.py``, pinned by
``tests/test_torch_io.py``: the same Capacities from the same clouds).

The reference never chooses capacities — its stages are std::vector and
grow per pair (FCCF.cpp throughout). Here every bound is a compile-time
static shape, so a NEW dataset needs either a content-measured registry
preset (models/fccf.py) or this module: ``auto_caps`` measures the cheap
quantities of the clouds EXACTLY on the host (raw/downsampled point
counts, occupied feature voxels, face-cell extents — one numpy ``unique``
each) and sizes the content-dependent ones (hypotheses, residual, fine
voxels) from the observed cross-family ratio envelopes with policy
headroom. Every bound stays guarded by the status-flag contract
(pipeline/register.py STATUS_*), and the intended pairing is sweep-level
escalation (``run_sweep(escalate_caps=...)`` / CLI ``--escalate-caps``)
so a tail pair outside the envelope re-runs at a generous compile instead
of shipping a flagged result.

CLI: ``--caps auto`` (see cli.py) computes this over the loaded scans.
"""

from __future__ import annotations

import numpy as np

from ..config import Capacities, FCCFParams

# Observed content ratios across the six measured scene families at the
# 0.005 curvature default (tools/measure_content.py numbers recorded in
# models/fccf.py; the tighter gate routes more points to the residual
# cloud, so these were re-measured with it):
#   residual / downsampled points: 0.10 (resso) .. 0.51 (apartment)
#   fine voxels / residual:        0.02 (apartment) .. 0.44 (heritage)
# The envelopes below cover the observed maxima; auto_caps multiplies
# them by the policy headroom (1.4x default) on top.
_RESIDUAL_PER_DOWN = 0.52
_FINE_PER_RESIDUAL = 0.45


def _ceil_to(x: float, q: int) -> int:
    return int(-(-int(np.ceil(x)) // q) * q)


def measure_cloud(points: np.ndarray, params: FCCFParams) -> dict:
    """Exact host-side content measurement of one raw cloud.

    n_down counts occupied leaf cells (= the VoxelGrid output size,
    exact: one centroid per occupied cell); n_fvox counts occupied
    feature voxels; span_cells is the per-axis face-cell extent."""
    n_raw = int(len(points))
    pts = np.asarray(points, np.float32)
    pts = pts[np.isfinite(pts).all(axis=1)]
    if len(pts) == 0:  # empty or all-NaN: raw count still real
        return dict(n_raw=n_raw, n_down=0, n_fvox=0,
                    span_cells=np.zeros(3, np.int64))
    leaf_cells = np.unique(
        np.floor(pts / params.leaf_size).astype(np.int64), axis=0
    )
    fcells = np.floor(pts / params.face_voxel_size).astype(np.int64)
    fmin, fmax = fcells.min(axis=0), fcells.max(axis=0)
    n_fvox = len(np.unique(fcells, axis=0))
    return dict(
        n_raw=int(len(points)),
        n_down=int(len(leaf_cells)),
        n_fvox=int(n_fvox),
        span_cells=(fmax - fmin + 1),
    )


def _fused_key_limits(params: FCCFParams):
    """Per-axis face-cell extent limits of the fused single-key sort
    (ops/voxelize.downsample_and_voxelize): the face key gets what
    remains of 31 bits after the within-face leaf index. Returns None
    when the leaf does not nest integrally (non-fused path: the
    wide_extent flag is irrelevant there)."""
    ratio = params.face_voxel_size / params.leaf_size
    if abs(ratio - round(ratio)) >= 1e-9 * max(ratio, 1.0):
        return None
    r = int(round(ratio))
    bits_w = max((r**3 - 1).bit_length(), 1)
    bits_f = 31 - bits_w
    bz = by = bits_f // 3
    bx = bits_f - by - bz
    return np.array([(1 << bx) - 1, (1 << by) - 1, (1 << bz) - 2], np.int64)


def auto_caps(clouds, params: FCCFParams, headroom: float = 1.4) -> Capacities:
    """Size a Capacities preset for these specific clouds.

    clouds: iterable of raw (N, 3) arrays (every cloud the run will see —
    for a pair, both of them). Exact bounds (points, voxels, extent) are
    measured; content-dependent bounds (hypotheses, residual, fine) come
    from the measured cross-family envelopes — pair with escalation for
    pairs outside them.
    """
    ms = [measure_cloud(c, params) for c in clouds]
    if not ms:
        raise ValueError("auto_caps needs at least one cloud")
    n_raw = max(m["n_raw"] for m in ms)
    n_down = max(m["n_down"] for m in ms)
    n_fvox = max(m["n_fvox"] for m in ms)
    span = np.maximum.reduce([m["span_cells"] for m in ms])

    lim = _fused_key_limits(params)
    wide = bool(lim is not None and np.any(span - 1 > lim))

    # max_points bounds the post-pre_downsample sort volume; n_down is
    # exact for these clouds, small slack absorbs f32-vs-float64 cell
    # boundary flips on other numerically-equal inputs.
    max_points = _ceil_to(n_down * 1.05 + 256, 1024)
    max_residual = min(
        max_points, _ceil_to(n_down * _RESIDUAL_PER_DOWN * headroom, 1024)
    )
    return Capacities(
        max_points=max_points,
        max_raw_points=_ceil_to(n_raw, 1024),
        # V rounds to 512 (the Pallas label-prop block contract:
        # ops/pallas/label_prop._block_sizes needs 128 | V and 512 | V)
        max_voxels=max(512, _ceil_to(n_fvox * headroom, 512)),
        # base matching / hypothesis fan-out has no cheap host-side
        # predictor (measured families span 183..7570 hypotheses
        # regardless of V — the structured hall family peaks under the
        # 0.005 curvature gate); use the family envelope, flag + escalate
        max_matches=4096,
        max_hypotheses=8192,
        max_reps=256,
        max_clusters=6144,
        max_residual=max_residual,
        # heritage-density scenes reach fine/residual = 0.44
        max_fine_voxels=max(2048, _ceil_to(max_residual * _FINE_PER_RESIDUAL, 1024)),
        # colonnade-style parallel-plane fan-out measured up to 30
        # third-plane hits/match (models/fccf.py heritage notes)
        per_match_hits=32,
        wide_extent=wide,
    )


def auto_escalation_caps(caps: Capacities) -> Capacities:
    """The escalation partner for an ``auto_caps`` result: doubles every
    content-dependent envelope bound (the exact, measured bounds — points,
    raw points, voxels — stay put: the clouds cannot grow). Dominates the
    input by construction, so it always passes run_sweep's check.

    ``wide_extent`` escalates to True: a preset running the single-key
    fused sort (the cheaper path — one sort operand fewer) clips
    outsized scenes into border cells and flags voxel overflow; the
    escalation re-run must restore the full two-key extent or the
    overflow would simply persist at the generous lanes."""
    return caps.replace(
        max_matches=2 * caps.max_matches,
        max_hypotheses=2 * caps.max_hypotheses,
        max_clusters=2 * caps.max_clusters,
        max_residual=min(caps.max_points, 2 * caps.max_residual),
        max_fine_voxels=2 * caps.max_fine_voxels,
        per_match_hits=2 * caps.per_match_hits,
        wide_extent=True,
    )
