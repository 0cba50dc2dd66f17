"""Closed-form rigid-transform hypothesis generation (port of
``fccf_pcr_tpu/hypotheses/transforms.py``: the base-matching loop
FCCF.cpp:1414-1427 and ``computer_transform`` :841-1018).

  1. (B1 x B2) compatibility (|angle difference| < 5 deg, same type),
     compacted to M matched base pairs in b1-major order.
  2. Per match, batched over M: the closed-form R = R2*R1, the
     third-plane fan-out over (source face s, target face t) with the
     3-plane translation solve, and the fallback translation.
  3. Hypotheses compacted to H slots in the reference's enumeration order
     (b1, b2, then s, then t, fallback last).

Reference quirks are kept as in the JAX package: raw (non-unit) face
normals feed every dot product, d22 pairs the untransformed target
centroid with the R1-rotated m2, and the A-matrix rows are the raw
source normals.

The three steps are the kernels H1 (``matches``), H2 (``slots``) and H3
(``emit``) of ``ops/hypotheses_kernels.py`` on a card, their plain
versions on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import Capacities, FCCFParams
from .faces import Faces
from . import hypotheses_kernels as hk


class Hypotheses(NamedTuple):
    """Leading batch dims (a pair axis) go before H."""

    quat: torch.Tensor      # (..., H, 4) w,x,y,z
    t: torch.Tensor         # (..., H, 3)
    type_: torch.Tensor     # (..., H) int32 in {0,1,2}
    valid: torch.Tensor     # (..., H) bool
    count: torch.Tensor     # (...) int32 valid hypotheses kept
    overflow: torch.Tensor  # (...) bool


def generate_hypotheses(f1: Faces, f2: Faces, params: FCCFParams,
                        caps: Capacities) -> Hypotheses:
    """Hypotheses of each face-set pair of the leading batch dims, from
    the faces' own bases (``select_bases``), which H1 forms with the
    matches on a card."""
    m = hk.matches(f1, f2, params, caps.max_matches)
    s = hk.slots(f1, f2, m, params, caps.per_match_hits)
    return Hypotheses(*hk.emit(s, m, caps.max_hypotheses))
