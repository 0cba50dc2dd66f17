"""Model registry: named (params, capacities) presets.

A jax-free copy of ``fccf_pcr_tpu/models/fccf.py``'s ``REGISTRY``; the
sizing rationale and the content measurements behind every capacity are
documented there. ``tests/test_torch_config.py`` pins the two registries
field by field.
"""

from __future__ import annotations

import dataclasses

from ..config import Capacities, FCCFParams, TEST_CAPS


@dataclasses.dataclass(frozen=True)
class FCCFModel:
    """A named, fully-specified registration pipeline configuration."""

    name: str
    params: FCCFParams
    caps: Capacities


_STANDARD_CAPS = Capacities(      # eth-office
    max_points=1 << 16,
    max_raw_points=1 << 17,
    max_voxels=1536,
    max_matches=1024,
    max_hypotheses=2048,
    max_reps=256,
    max_clusters=2048,
    max_residual=28672,
    max_fine_voxels=2048,
)

_DENSE_CAPS = dataclasses.replace(  # eth-apartment
    _STANDARD_CAPS,
    max_points=1 << 17,
    max_raw_points=1 << 18,
    max_voxels=1024,
    max_hypotheses=4096,
    max_residual=1 << 16,
    max_fine_voxels=2048,
)

_STRUCTURED_CAPS = dataclasses.replace(  # eth-structured
    _STANDARD_CAPS,
    max_points=98304,
    max_raw_points=147456,
    max_voxels=4096,
    max_matches=4096,
    max_hypotheses=8192,
    max_clusters=6144,
    max_residual=28672,
    max_fine_voxels=4096,
)

_OUTDOOR_CAPS = dataclasses.replace(  # eth-outdoor
    _STANDARD_CAPS,
    max_raw_points=1 << 18,
    max_matches=2048,
    max_hypotheses=2560,
    max_residual=28672,
    max_fine_voxels=2048,
)

_RESSO_CAPS = Capacities(
    max_points=73728,
    max_raw_points=81920,
    max_voxels=9216,
    max_matches=1536,
    max_hypotheses=1536,
    max_reps=256,
    max_clusters=1024,
    max_residual=10240,
    max_fine_voxels=4096,
    wide_extent=True,
)

_HERITAGE_CAPS = Capacities(
    max_points=245760,
    max_raw_points=294912,
    max_voxels=9216,
    max_matches=2048,
    max_hypotheses=3072,
    max_reps=256,
    max_clusters=2048,
    max_residual=53248,
    per_match_hits=48,
    max_fine_voxels=1 << 15,
    wide_extent=True,
)

REGISTRY = {
    "eth-office": FCCFModel(
        "eth-office", FCCFParams(leaf_size=0.1), _STANDARD_CAPS
    ),
    "eth-apartment": FCCFModel(
        "eth-apartment", FCCFParams(leaf_size=0.05), _DENSE_CAPS
    ),
    "eth-structured": FCCFModel(
        "eth-structured", FCCFParams(leaf_size=0.1), _STRUCTURED_CAPS
    ),
    "eth-outdoor": FCCFModel(
        "eth-outdoor", FCCFParams(leaf_size=0.1), _OUTDOOR_CAPS
    ),
    "resso": FCCFModel("resso", FCCFParams(leaf_size=0.1), _RESSO_CAPS),
    "heritage": FCCFModel(
        "heritage",
        FCCFParams(leaf_size=0.2, face_voxel_size=2.0),
        _HERITAGE_CAPS,
    ),
    "tiny": FCCFModel("tiny", FCCFParams(leaf_size=0.25), TEST_CAPS),
}


def get_model(name: str) -> FCCFModel:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]
