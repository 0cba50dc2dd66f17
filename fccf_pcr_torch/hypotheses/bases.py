"""Coplane-pair base enumeration and roughness typing (port of
``fccf_pcr_tpu/hypotheses/bases.py``, ``select_base`` FCCF.cpp:429-468).

All face pairs (i < j) in the reference's nested-loop order, valid when
their included angle lies strictly inside (30, 150) degrees, typed
0/1/2 (smooth-smooth / rough-rough / mixed) by theta against 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FCCFParams
from ..features.faces import Faces
from ..ops import geometry


class Bases(NamedTuple):
    """Leading batch dims (a pair axis) go before B."""

    i: torch.Tensor       # (..., B) int64 face index 1 (i < j)
    j: torch.Tensor       # (..., B) int64 face index 2
    angle: torch.Tensor   # (..., B) included angle, degrees
    type_: torch.Tensor   # (..., B) int32 in {0,1,2}
    valid: torch.Tensor   # (..., B) bool


def pair_indices(F: int, device="cpu"):
    """Static (i, j) pairs, i < j, in the reference's nested-loop order."""
    ij = torch.triu_indices(F, F, offset=1, device=device)
    return ij[0], ij[1]


def select_bases(faces: Faces, params: FCCFParams) -> Bases:
    """Bases of each face set of the leading batch dims."""
    F = faces.valid.shape[-1]
    ii, jj = pair_indices(F, faces.valid.device)
    angle = geometry.angle_deg(faces.normal[..., ii, :],
                               faces.normal[..., jj, :])
    valid = (
        faces.valid[..., ii]
        & faces.valid[..., jj]
        & (angle > params.angle_min)
        & (angle < params.angle_max)
    )
    rough_i = faces.theta[..., ii] > params.rough_threshold
    rough_j = faces.theta[..., jj] > params.rough_threshold
    # both smooth -> 0, both rough -> 1, mixed -> 2 (FCCF.cpp:454-461)
    type_ = torch.where(
        rough_i == rough_j, torch.where(rough_i, 1, 0), 2
    ).to(torch.int32)
    return Bases(i=ii.expand(valid.shape), j=jj.expand(valid.shape),
                 angle=angle, type_=type_, valid=valid)
