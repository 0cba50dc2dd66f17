"""Scene configurations, accuracy gates and the seed-to-scene assignment
of the evaluation (a jax-free copy of ``bench.py``'s ``CONFIGS``,
``GATES``, ``_coerce_like`` and ``pairs_for_config``, pinned to them by
``tests/test_torch_evaluation.py``).

Each ``CONFIGS`` entry names a model preset (``models/fccf.py``), the
scene keyword arguments of ``io.synthetic.make_pair`` (``scene``, or a
list ``scenes`` that mixed-family configs round-robin by seed) and the
pair keyword arguments (``pair``). ``sweep`` is a sequence config, a
throughput proxy whose scene family the office config evaluates.
"""

from __future__ import annotations

from ..io import synthetic

CONFIGS = {
    "office": dict(
        model="eth-office",
        scene=dict(points_per_plane=12000, clutter_points=4000, noise=0.004),
        pair=dict(),
    ),
    "apartment": dict(  # denser indoor: finer leaf, more voxel planes
        model="eth-apartment",
        scene=dict(
            points_per_plane=24000, clutter_points=8000, noise=0.003,
            room=(9.0, 7.0, 3.0),
        ),
        pair=dict(),
    ),
    "cross-season": dict(  # low overlap, heavy clutter
        model="eth-outdoor",
        scene=dict(points_per_plane=9000, clutter_points=12000, noise=0.01),
        pair=dict(dropout=0.45, max_angle_deg=60.0, max_trans=6.0),
    ),
    "structured": dict(  # stair flights and building halls in one batch
        model="eth-structured",
        scenes=[
            dict(scene="stairs", points_per_plane=12000,
                 clutter_points=4000, noise=0.004),
            dict(scene="hall", points_per_plane=14000,
                 clutter_points=6000, noise=0.006),
        ],
        pair=dict(),
    ),
    "sweep": dict(  # consecutive pairs of a drifting scan trajectory
        model="eth-office",
        sequence=dict(n_scans=17, step_angle_deg=12.0, step_trans=0.8,
                      points_per_plane=12000, clutter_points=4000,
                      noise=0.004),
        pair=dict(),
    ),
    "resso": dict(  # building exterior: ~50 m extent, few large planes
        model="resso",
        scene=dict(scene="facade", density=18.0, clutter_points=6000,
                   noise=0.012),
        pair=dict(max_angle_deg=40.0, max_trans=6.0, dropout=0.25),
    ),
    "heritage": dict(  # >100 m courtyard, ~230k-point clouds
        model="heritage",
        scene=dict(scene="courtyard", density=14.0, clutter_points=8000,
                   noise=0.015),
        pair=dict(max_angle_deg=40.0, max_trans=8.0, dropout=0.25),
        batch=8,
    ),
}

# Per-config accuracy gates (RRE deg, RTE m) over a batch; configs absent
# here use the global fallback (2 deg / 0.3 m).
GATES = {
    "office": (0.5, 0.08),
    "apartment": (0.5, 0.08),
    "structured": (2.0, 0.2),
    "cross-season": (1.0, 0.15),
    "sweep": (1.0, 0.15),
    "resso": (1.0, 0.25),
    "heritage": (1.5, 0.3),
}


def pairs_for_config(cfg, seeds):
    """(src, tar, T_gt) pairs for a ``CONFIGS`` entry: one pair per seed;
    mixed-family configs round-robin the family by seed value."""
    fams = cfg.get("scenes")
    return [
        synthetic.make_pair(
            seed=s,
            **(fams[s % len(fams)] if fams else cfg["scene"]),
            **cfg["pair"],
        )
        for s in seeds
    ]


def coerce_like(cur, key, val, flag):
    """Parse ``val`` to the type of the current field value ``cur``
    (bool parsing is strict: a typo must not silently evaluate the
    opposite configuration)."""
    if isinstance(cur, bool):
        v = val.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{flag} {key}: not a boolean: {val!r}")
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    raise ValueError(f"{flag} {key}: unsupported field type {type(cur)}")
