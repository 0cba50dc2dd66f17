"""Coplane-pair base enumeration and roughness typing (port of
``fccf_pcr_tpu/hypotheses/bases.py``, ``select_base`` FCCF.cpp:429-468).

All face pairs (i < j) in the reference's nested-loop order, valid when
their included angle lies strictly inside (30, 150) degrees, typed
0/1/2 (smooth-smooth / rough-rough / mixed) by theta against 2: H1's
bases form on a card, ``ops/hypotheses_kernels.bases_plain`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FCCFParams
from ..features.faces import Faces
from ..ops import hypotheses_kernels


class Bases(NamedTuple):
    """Leading batch dims (a pair axis) go before B."""

    i: torch.Tensor       # (..., B) int64 face index 1 (i < j)
    j: torch.Tensor       # (..., B) int64 face index 2
    angle: torch.Tensor   # (..., B) included angle, degrees
    type_: torch.Tensor   # (..., B) int32 in {0,1,2}
    valid: torch.Tensor   # (..., B) bool


def select_bases(faces: Faces, params: FCCFParams) -> Bases:
    """Bases of each face set of the leading batch dims."""
    return Bases(*hypotheses_kernels.bases(faces, params))
