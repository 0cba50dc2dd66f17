"""Synthetic structured-scene generation: the benchmark's frozen copy of
``fccf_pcr_torch/io/synthetic.py`` (NumPy only) and of
``fccf_pcr_torch/io/points.py::pad_points``, so that a later change to the
program's generator cannot move the benchmark's inputs.

The reference is evaluated on ETH laser scans (indoor/structured scenes
dominated by large planes — walls, floors, ceilings). No dataset ships with
this repo, so tests and benchmarks use synthetic scenes with the same
statistics: a handful of large planes at varied orientations, plus
non-planar clutter, sampled as two overlapping "scans" related by a known
ground-truth SE(3). Property tests then assert RTE/RRE ~ 0 (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np


def make_plane(rng, center, normal, extent, n_points, noise=0.005,
               u_hint=None):
    """Sample n_points from a finite plane patch with Gaussian noise.

    extent[0] spans the u axis, extent[1] the v axis. Without ``u_hint``
    the in-plane basis is an arbitrary deterministic function of the
    normal (u = normal x ref); pass ``u_hint`` (any vector not parallel
    to the normal) to pin u = the hint projected into the plane — needed
    when a patch's two extents must land on specific world directions
    (stair treads, pillar strips)."""
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    if u_hint is not None:
        h = np.asarray(u_hint, np.float64)
        u = h - (h @ normal) * normal
        u /= np.linalg.norm(u)
    else:
        # Arbitrary deterministic basis in the plane.
        a = np.array([1.0, 0.0, 0.0])
        if abs(normal @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        u = np.cross(normal, a)
        u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    uv = rng.uniform(-0.5, 0.5, (n_points, 2)) * np.asarray(extent)
    pts = center + uv[:, :1] * u + uv[:, 1:2] * v
    pts += rng.normal(0.0, noise, (n_points, 1)) * normal
    return pts


def make_room_scene(seed=0, points_per_plane=4000, clutter_points=2000,
                    room=(14.0, 10.0, 4.0), noise=0.005):
    """A room-like scene: floor, ceiling, 4 walls, 2 interior partitions,
    plus ellipsoidal clutter (exercises the curvature gate / residual
    cloud). Returns (points (M,3) float32).

    KNOWN GEOMETRY QUIRK (kept deliberately): make_plane without u_hint
    picks its own in-plane axes, so each patch's (a, b) extents land on
    rotated axes — e.g. the x-normal walls span `b` along y but `a`
    along z, extending past the nominal box. The result is still a valid
    multi-plane indoor scene with exact ground truth, and EVERY measured
    artifact is calibrated to exactly this geometry: capacity presets
    (models/fccf.py), golden fixtures (tests/golden/), the benchmark and
    evaluation tables. Re-aligning the patches (passing u_hint, as the
    stairs/hall generators do) would invalidate all of them for no
    accuracy or coverage gain — do not "fix" this without re-measuring
    everything on hardware."""
    rng = np.random.default_rng(seed)
    L, W, Hh = room
    planes = [
        # floor / ceiling
        ((L / 2, W / 2, 0.0), (0, 0, 1), (L, W)),
        ((L / 2, W / 2, Hh), (0, 0, 1), (L, W)),
        # outer walls
        ((0.0, W / 2, Hh / 2), (1, 0, 0), (W, Hh)),
        ((L, W / 2, Hh / 2), (1, 0, 0), (W, Hh)),
        ((L / 2, 0.0, Hh / 2), (0, 1, 0), (L, Hh)),
        ((L / 2, W, Hh / 2), (0, 1, 0), (L, Hh)),
        # interior structure breaking BOTH the 90- and 180-degree box
        # symmetries (a bare box registers ambiguously — the flipped
        # transform matches 8 of its faces; real scans are asymmetric):
        # two vertical partitions at odd angles + two large slanted planes
        # confined to one corner each.
        ((L / 3, W / 2, Hh / 2), (0.8, 0.6, 0), (W * 0.7, Hh)),
        ((2 * L / 3, W / 3, Hh / 2), (0.45, -0.89, 0), (W * 0.6, Hh)),
        ((L * 0.2, W * 0.75, Hh * 0.55), (0.5, 0.1, 0.86), (W * 0.5, Hh * 0.9)),
        ((L * 0.8, W * 0.2, Hh * 0.4), (-0.2, 0.6, 0.77), (W * 0.45, Hh * 0.8)),
    ]
    parts = [
        make_plane(rng, np.asarray(c, np.float64), n, e, points_per_plane, noise)
        for c, n, e in planes
    ]
    # Clutter: noisy blobs (high curvature -> residual cloud).
    for _ in range(6):
        center = rng.uniform([1, 1, 0.3], [L - 1, W - 1, Hh - 0.5])
        blob = center + rng.normal(0.0, 0.35, (clutter_points // 6, 3))
        parts.append(blob)
    pts = np.concatenate(parts, axis=0)
    return pts.astype(np.float32)


def make_stairs_scene(seed=0, points_per_plane=4000, clutter_points=2000,
                      noise=0.005, n_steps=10, tread=0.30, rise=0.18,
                      width=2.4):
    """A stairwell: large bounding planes (the registrable structure) plus
    a staircase of small tread/riser planes. Each 0.3 m tread mixes with
    its risers inside one 1.0 m feature voxel, so the steps land in the
    curvature-gated residual cloud (FCCF.cpp:497 analog) and exercise
    fine verification, like ETH "Stairs"."""
    rng = np.random.default_rng(seed)
    run = n_steps * tread
    height = n_steps * rise
    L, W, Hh = run + 4.0, width + 3.0, height + 2.5
    X = (1.0, 0.0, 0.0)
    Y = (0.0, 1.0, 0.0)
    # (center, normal, (extent_u, extent_v), u_hint): u_hint pins which
    # world direction extent_u spans (see make_plane).
    planes = [
        # lower + upper landings (floor level and top of the flight)
        ((1.0, W / 2, 0.0), (0, 0, 1), (2.0, W), X),
        ((run + 3.0, W / 2, height), (0, 0, 1), (2.0, W), X),
        # side walls, ceiling slab, back wall
        ((L / 2, 0.0, Hh / 2), (0, 1, 0), (L, Hh), X),
        ((L / 2, W, Hh / 2), (0, 1, 0), (L, Hh), X),
        ((L / 2, W / 2, Hh), (0, 0, 1), (L, W), X),
        ((0.0, W / 2, Hh / 2), (1, 0, 0), (W, Hh), Y),
        # sloped ramp wall under the flight + an angled partition
        # (breaks the front/back symmetry of the stairwell box)
        ((2.0 + run / 2, W * 0.25, height / 2),
         (rise, 0.15 * tread, -tread), (run * 0.8, W * 0.4), X),
        ((L * 0.7, W * 0.6, Hh * 0.45), (0.7, 0.6, 0.25), (W, Hh * 0.7), Y),
    ]
    parts = [
        make_plane(rng, np.asarray(c, np.float64), n, e, points_per_plane,
                   noise, u_hint=h)
        for c, n, e, h in planes
    ]
    # The flight itself: small treads + risers (residual-cloud fodder).
    per_step = max(points_per_plane // (2 * n_steps), 64)
    for i in range(n_steps):
        x0 = 2.0 + i * tread
        z1 = (i + 1) * rise
        parts.append(make_plane(
            rng, np.array([x0 + tread / 2, W / 2, z1]), (0, 0, 1),
            (tread, width), per_step, noise, u_hint=X))
        parts.append(make_plane(
            rng, np.array([x0, W / 2, z1 - rise / 2]), (1, 0, 0),
            (width, rise), per_step, noise, u_hint=Y))
    for _ in range(4):
        center = rng.uniform([1, 0.5, 0.3], [L - 1, W - 0.5, 2.0])
        blob = center + rng.normal(0.0, 0.25, (clutter_points // 4, 3))
        parts.append(blob)
    return np.concatenate(parts, axis=0).astype(np.float32)


def make_hall_scene(seed=0, points_per_plane=4000, clutter_points=2000,
                    noise=0.005, hall=(30.0, 12.0, 8.0), n_pillars=6):
    """A large building hall (ETH "Hauptgebaude" proxy): long floor /
    ceiling / walls at building scale, a mezzanine slab, an angled end
    facade, and rows of pillars whose small faces mostly fall below the
    per-voxel point gate (FCCF.cpp:486 analog) or into the residual."""
    rng = np.random.default_rng(seed)
    L, W, Hh = hall
    X = (1.0, 0.0, 0.0)
    Y = (0.0, 1.0, 0.0)
    planes = [
        ((L / 2, W / 2, 0.0), (0, 0, 1), (L, W), X),
        ((L / 2, W / 2, Hh), (0, 0, 1), (L, W), X),
        ((L / 2, 0.0, Hh / 2), (0, 1, 0), (L, Hh), X),
        ((L / 2, W, Hh / 2), (0, 1, 0), (L, Hh), X),
        ((0.0, W / 2, Hh / 2), (1, 0, 0), (W, Hh), Y),
        # angled end facade instead of a square wall (asymmetry)
        ((L, W / 2, Hh / 2), (0.92, 0.38, 0), (W * 1.1, Hh), Y),
        # mezzanine slab along one side + its slanted stair ramp
        ((L * 0.3, W * 0.2, Hh * 0.45), (0, 0, 1), (L * 0.5, W * 0.35), X),
        ((L * 0.62, W * 0.2, Hh * 0.22),
         (0.45, 0.0, 0.89), (W * 0.35, Hh * 0.5), Y),
    ]
    parts = [
        make_plane(rng, np.asarray(c, np.float64), n, e, points_per_plane,
                   noise, u_hint=h)
        for c, n, e, h in planes
    ]
    # Pillar rows: 4 narrow vertical strips each (0.6 m wide, sub-voxel).
    per_face = max(points_per_plane // (4 * n_pillars), 64)
    for i in range(n_pillars):
        cx = L * (i + 1.0) / (n_pillars + 1.0)
        for cy in (W * 0.3, W * 0.7):
            for nrm, off, hint in (
                ((1, 0, 0), (0.3, 0.0), Y),
                ((0, 1, 0), (0.0, 0.3), X),
            ):
                parts.append(make_plane(
                    rng, np.array([cx + off[0], cy + off[1], Hh * 0.35]),
                    nrm, (0.6, Hh * 0.7), per_face, noise, u_hint=hint))
    for _ in range(6):
        center = rng.uniform([2, 1, 0.3], [L - 2, W - 1, 2.5])
        blob = center + rng.normal(0.0, 0.4, (clutter_points // 6, 3))
        parts.append(blob)
    return np.concatenate(parts, axis=0).astype(np.float32)


def _area_plane(rng, center, normal, extent, density, noise, u_hint=None,
                min_points=96):
    """make_plane with the point count set by surface density (pts/m^2) —
    building-scale patches vary over two orders of magnitude in area, so a
    fixed per-plane budget would leave big facades too sparse to pass the
    per-voxel point gate (FCCF.cpp:486) while drowning small features."""
    n = max(int(extent[0] * extent[1] * density), min_points)
    return make_plane(rng, np.asarray(center, np.float64), normal, extent,
                      n, noise, u_hint=u_hint)


def make_facade_scene(seed=0, density=18.0, clutter_points=6000,
                      noise=0.012, block=(52.0, 36.0, 16.0)):
    """RESSO proxy: a building-exterior block scan (~50 m extent).

    Two street facades with an annex wing at an odd angle, a sloped roof
    plane, a partial ground apron, and an interior courtyard wall — the
    plane statistics of the RESSO building scans (BASELINE.md Table I,
    scenes 6i-7e): few very large planes, tens of meters apart, outdoor
    noise. ``density`` is points/m^2 (LiDAR-like sparse coverage rather
    than the indoor scenes' fixed per-plane budgets).
    """
    rng = np.random.default_rng(seed)
    L, W, Hh = block
    X = (1.0, 0.0, 0.0)
    Y = (0.0, 1.0, 0.0)
    planes = [
        # main street facade + side facade
        ((L / 2, 0.0, Hh / 2), (0, 1, 0), (L, Hh), X),
        ((0.0, W / 2, Hh / 2), (1, 0, 0), (W, Hh), Y),
        # back facade (slightly angled - breaks the box symmetry)
        ((L / 2, W, Hh / 2), (0.1, 0.99, 0), (L, Hh), X),
        # annex wing at an odd angle off the side facade
        ((L * 0.75, W * 0.72, Hh * 0.31),
         (0.62, -0.78, 0), (W * 0.55, Hh * 0.62), (0.78, 0.62, 0.0)),
        # ground apron around the block (partial: scans see near-ground)
        ((L / 2, W * 0.28, 0.0), (0, 0, 1), (L * 0.9, W * 0.5), X),
        # sloped roof plane visible from across the street
        ((L / 2, W * 0.35, Hh + 2.0), (0, 0.45, 0.89), (L * 0.8, 9.0), X),
        # courtyard wall fragment, lower height
        ((L * 0.3, W * 0.55, Hh * 0.2), (0.95, 0.31, 0),
         (W * 0.3, Hh * 0.4), (0.31, -0.95, 0.0)),
    ]
    parts = [
        _area_plane(rng, c, n, e, density, noise, u_hint=h)
        for c, n, e, h in planes
    ]
    # Street furniture / vegetation clutter (residual-cloud fodder).
    for _ in range(8):
        center = rng.uniform([3, -2, 0.3], [L - 3, W * 0.5, 3.0])
        blob = center + rng.normal(0.0, 0.5, (clutter_points // 8, 3))
        parts.append(blob)
    return np.concatenate(parts, axis=0).astype(np.float32)


def make_courtyard_scene(seed=0, density=14.0, clutter_points=8000,
                         noise=0.015, court=(108.0, 86.0, 20.0),
                         n_columns=10):
    """Heritage proxy: a large historic courtyard scan (>100 m extent —
    the Table I scale of the reference's hardest published scene,
    Heritage, 2.66 s). Ground, four high facades (one angled, one with a
    recessed gallery), a colonnade of thick square columns along one
    side, and a tower corner. Column faces are ~1.2 m wide: a family of
    many parallel planes, the building-scale analog of the pillar-hall
    third-plane fan-out (per_match_hits sizing)."""
    rng = np.random.default_rng(seed)
    L, W, Hh = court
    X = (1.0, 0.0, 0.0)
    Y = (0.0, 1.0, 0.0)
    planes = [
        # courtyard ground (scans cover most of it)
        ((L / 2, W / 2, 0.0), (0, 0, 1), (L, W), X),
        # four facades; the far one strongly angled — a courtyard that is
        # a true rectangle is 90/180-degree ambiguous to any plane-based
        # matcher (the base included-angle gate is 5 deg, so symmetry
        # breaks must exceed it by a wide margin)
        ((L / 2, 0.0, Hh / 2), (0, 1, 0), (L, Hh), X),
        ((L / 2, W, Hh / 2), (0.26, 0.97, 0), (L, Hh), X),
        ((0.0, W / 2, Hh / 2), (1, 0, 0), (W, Hh), Y),
        ((L, W / 2, Hh * 0.38), (1, 0, 0), (W, Hh * 0.75), Y),
        # large diagonal wing wall crossing one corner (~42 deg: the
        # dominant symmetry breaker, like the hall's angled end facade)
        ((L * 0.78, W * 0.78, Hh * 0.45), (0.67, 0.74, 0),
         (W * 0.55, Hh * 0.9), (0.74, -0.67, 0.0)),
        # recessed gallery wall behind the colonnade side (10+ m recess:
        # closer parallel pairs alias against the 2 m coplanarity gate)
        ((L / 2, W * 0.12, Hh * 0.2), (0, 1, 0), (L * 0.6, Hh * 0.4), X),
        # tower corner: two higher wall panels past the main roofline
        ((L * 0.12, W * 0.97, Hh * 1.3), (0, 1, 0), (L * 0.2, Hh * 0.6), X),
        ((L * 0.02, W * 0.88, Hh * 1.3), (1, 0, 0), (W * 0.18, Hh * 0.6), Y),
        # broad entrance ramp, tilted off every axis
        ((L * 0.78, W * 0.45, 1.4), (-0.22, 0.14, 0.97),
         (L * 0.18, W * 0.22), X),
        # sloped porch roof over the gallery (non-vertical large plane)
        ((L * 0.35, W * 0.1, Hh * 0.55), (0, 0.5, 0.87),
         (L * 0.4, 6.0), X),
    ]
    parts = [
        _area_plane(rng, c, n, e, density, noise, u_hint=h)
        for c, n, e, h in planes
    ]
    # Colonnade: thick square columns (1.2 m faces, 8 m tall) along the
    # gallery side — many parallel sub-facade planes.
    col_density = density * 1.5  # columns are near the scanner path
    for i in range(n_columns):
        cx = L * (i + 1.0) / (n_columns + 1.0)
        cy = W * 0.12
        for nrm, off, hint in (
            ((0, 1, 0), (0.0, 0.6), X),
            ((0, 1, 0), (0.0, -0.6), X),
            ((1, 0, 0), (0.6, 0.0), Y),
            ((1, 0, 0), (-0.6, 0.0), Y),
        ):
            parts.append(_area_plane(
                rng, (cx + off[0], cy + off[1], 4.0), nrm, (1.2, 8.0),
                col_density, noise, u_hint=hint))
    # Statues / vegetation / visitors: non-planar clutter.
    for _ in range(10):
        center = rng.uniform([5, 5, 0.3], [L - 5, W - 5, 3.5])
        blob = center + rng.normal(0.0, 0.6, (clutter_points // 10, 3))
        parts.append(blob)
    return np.concatenate(parts, axis=0).astype(np.float32)


SCENES = {
    "room": make_room_scene,
    "stairs": make_stairs_scene,
    "hall": make_hall_scene,
    "facade": make_facade_scene,
    "courtyard": make_courtyard_scene,
}


def random_se3(rng, max_angle_deg=40.0, max_trans=3.0):
    """Random rigid transform with bounded rotation/translation.

    The rotation floor avoids near-identity degenerate pairs; when the
    requested bound is itself small, the floor scales down so the bound
    stays honored (numpy's uniform(low, high) silently SWAPS a reversed
    range, which would sample rotations larger than requested)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    lo = min(5.0, 0.5 * max_angle_deg)
    ang = np.deg2rad(rng.uniform(lo, max_angle_deg))
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    t = rng.uniform(-max_trans, max_trans, 3)
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = t
    return T.astype(np.float32)


def make_pair(seed=0, max_angle_deg=40.0, max_trans=3.0, dropout=0.15,
              scene="room", overlap=1.0, **scene_kw):
    """Build (src_points, tar_points, T_gt) with T_gt mapping src -> tar.

    The target cloud is the scene itself; the source cloud is the scene
    viewed in a different frame (apply inverse of T_gt) with partial
    dropout + independent noise realization, emulating two scans of the
    same scene from different poses. ``scene`` picks a generator from
    ``SCENES`` (room / stairs / hall).

    ``overlap`` < 1.0 makes the pair a PARTIAL-overlap registration (the
    regime of the reference's RESSO scenes, BASELINE.md Tables II-III):
    each scan is windowed to a contiguous slab covering (1+overlap)/2 of
    the scene's extent along one horizontal axis, from opposite ends, so
    the shared region is exactly ``overlap`` of the extent. Faces outside
    the shared slab have no counterpart in the other scan — the 0.8
    fusion gate and per-type logic must reject their one-sided matches.
    The windowing axis comes from an rng stream independent of the pose
    draw, so T_gt for a given seed is IDENTICAL across overlap levels
    (clean success-vs-overlap curves). Default 1.0 = full overlap,
    bit-identical to the pre-overlap generator (every calibrated
    fixture/preset assumes this default).
    """
    make_scene = SCENES[scene]
    rng = np.random.default_rng(seed + 99991)
    tar = make_scene(seed=seed, **scene_kw)
    src_world = make_scene(seed=seed + 1, **scene_kw)
    keep = rng.uniform(size=src_world.shape[0]) > dropout
    src_world = src_world[keep]
    T_gt = random_se3(rng, max_angle_deg, max_trans)
    if not 0.0 < overlap <= 1.0:
        raise ValueError(f"overlap must be in (0, 1]: {overlap}")
    if overlap < 1.0:
        # Window AFTER the pose draw (separate rng): same T_gt per seed
        # at every overlap level.
        wrng = np.random.default_rng(seed + 424243)
        axis = int(wrng.integers(2))  # horizontal axes only: x or y
        lo = min(tar[:, axis].min(), src_world[:, axis].min())
        hi = max(tar[:, axis].max(), src_world[:, axis].max())
        cover = (1.0 + overlap) / 2.0 * (hi - lo)
        # which scan takes which end also varies per seed
        if int(wrng.integers(2)):
            tar_keep = tar[:, axis] <= lo + cover
            src_keep = src_world[:, axis] >= hi - cover
        else:
            tar_keep = tar[:, axis] >= hi - cover
            src_keep = src_world[:, axis] <= lo + cover
        tar = tar[tar_keep]
        src_world = src_world[src_keep]
    # src = T_gt^{-1} applied to world coords; then T_gt maps src -> tar.
    R = T_gt[:3, :3]
    t = T_gt[:3, 3]
    src = (src_world - t) @ R  # R^T (x - t)
    return src.astype(np.float32), tar.astype(np.float32), T_gt


def make_sequence(seed=0, n_scans=9, step_angle_deg=12.0, step_trans=0.8,
                  dropout=0.15, scene="room", **scene_kw):
    """A drifting scan trajectory over one scene: the full-sequence-sweep
    analog of registering all consecutive pairs of an ETH dataset
    (BASELINE.json config 5).

    Scan k is an independent sampling of the scene (own noise/dropout
    realization) expressed in its own sensor frame; frames drift by a
    bounded random SE(3) increment per step. Returns (scans, T_rel, poses)
    where ``scans`` is a list of (M_k, 3) float32 clouds, ``T_rel[k]``
    maps scan k's frame into scan k+1's frame (the per-pair ground truth),
    and ``poses[k]`` maps scan k's frame into the world frame
    (``poses[k+1] @ T_rel[k] == poses[k]``).
    """
    rng = np.random.default_rng(seed + 7777)
    make_scene = SCENES[scene]
    # pose[k] maps scan-k sensor frame -> world
    pose = np.eye(4, dtype=np.float64)
    scans, poses = [], []
    for k in range(n_scans):
        world = make_scene(seed=seed + 31 * k, **scene_kw).astype(np.float64)
        keep = rng.uniform(size=world.shape[0]) > dropout
        world = world[keep]
        R, t = pose[:3, :3], pose[:3, 3]
        scans.append(((world - t) @ R).astype(np.float32))
        poses.append(pose)
        step = random_se3(rng, step_angle_deg, step_trans).astype(np.float64)
        pose = pose @ step
    T_rel = [
        (np.linalg.inv(poses[k + 1]) @ poses[k]).astype(np.float32)
        for k in range(n_scans - 1)
    ]
    return scans, T_rel, [p.astype(np.float32) for p in poses]


def pad_points(pts, capacity):
    """Pad (M,3) points to (capacity,3) + mask. Overflow is subsampled
    deterministically (every k-th point)."""
    m = pts.shape[0]
    if m > capacity:
        idx = np.linspace(0, m - 1, capacity).astype(np.int64)
        pts = pts[idx]
        m = capacity
    out = np.zeros((capacity, 3), np.float32)
    out[:m] = pts
    mask = np.zeros((capacity,), bool)
    mask[:m] = True
    return out, mask
