"""Parameters and capacities of the reference: a frozen copy of
``fccf_pcr_torch/config.py``'s dataclasses. The benchmark fills both
from a configuration file, field by field."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FCCFParams:
    """Algorithm parameters (see ``fccf_pcr_tpu.config.FCCFParams``)."""

    l1: float = 0.5
    l2: float = 1.0
    k1: float = 5.0
    k2: float = 2.0
    normal_thresh1: float = 5.0
    normal_thresh2: float = 8.0
    face_voxel_size: float = 1.0
    voxel_point_threshold: int = 5
    # Plane-fit curvature gate; the reference uses 0.05 (FCCF.cpp:138).
    # 0.005 is the JAX package's documented accuracy divergence
    # (docs/PARITY.md divergence 9), kept so outputs compare 1:1.
    curvature_threshold: float = 0.005
    select_plane_number: int = 15
    qv_angle: float = 10.0
    qv_dist: float = 2.0
    required_optimize: int = 4
    fine_voxel: float = 0.5
    fine_verify_number: int = 4
    angle_same: float = 5.0
    angle_min: float = 30.0
    angle_max: float = 150.0
    third_plane_threshold: float = 0.5
    third_normal_threshold: float = 5.0
    cluster_count_threshold: int = 10
    cluster_angle: float = 2.0
    cluster_dist: float = 0.8
    select_cluster_number: int = 200
    rough_threshold: float = 2.0
    leaf_size: float = 0.1
    # Levenberg-Marquardt iterations replacing Ceres DENSE_QR max 50.
    refine_iters: int = 50
    # Label-propagation sweep cap for face growth.
    label_prop_iters: int = 32
    # Type-gate in the final fusion (FCCF.cpp:1601).
    fuse_gate: float = 0.8
    # Rotation-consistency gate for fusion (degrees; 0 = reference blind
    # average), default on at 10 as in the JAX package.
    fuse_rotation_gate_deg: float = 10.0

    def replace(self, **kw) -> "FCCFParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Static shape bounds for the masked tensor pipeline. Overflow
    degrades gracefully: entries past a bound are dropped and a status
    bit is raised."""

    max_points: int = 1 << 18
    max_voxels: int = 4096
    max_faces: int = 16
    max_matches: int = 2048
    max_hypotheses: int = 8192
    max_reps: int = 256
    max_clusters: int = 2048
    max_residual: int = 1 << 16
    per_match_hits: int = 16
    max_fine_voxels: int = 1 << 15
    # Raw-load capacity consumed by pre_downsample; 0 = max_points.
    max_raw_points: int = 0
    # Two-key voxelization layout for building-scale extents.
    wide_extent: bool = False

    @property
    def raw_points(self) -> int:
        return self.max_raw_points or self.max_points

    @property
    def max_bases(self) -> int:
        f = self.max_faces
        return f * (f - 1) // 2

    def replace(self, **kw) -> "Capacities":
        return dataclasses.replace(self, **kw)
