"""Quick (coarse) verification (port of ``fccf_pcr_tpu/verify/quick.py``;
``quick_verify`` FCCF.cpp:680-783).

Transform the target faces, find coplanar source-target face pairs (angle
< 10 deg and plane-offset difference < 2 m), keep the best candidate per
source face by min/max size ratio, score the sum of pair importances, and
refine the transform when >= 4 pairs matched. Both functions take a batch
of transforms (..., 4, 4) in place of the JAX package's vmaps.
"""

from __future__ import annotations

import torch

from ..config import FCCFParams
from ..features.faces import Faces
from ..ops import geometry
from ..refine.gauss_newton import refine_pairs


def match_faces(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Pair matching + scoring under transforms T (..., 4, 4) (:683-769).
    Returns (score (...), n_pairs (...), n2t_best (..., F, 3),
    c2t_best (..., F, 3), importance (..., F)). Pair selection and score
    use the transform before refinement, as in the reference."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    c2t = f2.centroid @ R.mT + t[..., None, :]
    n2t = f2.normal @ R.mT

    size1 = torch.sum(torch.where(f1.valid, f1.point_size, 0.0))
    size2 = torch.sum(torch.where(f2.valid, f2.point_size, 0.0))

    ang = geometry.angle_deg(f1.normal[:, None, :], n2t[..., None, :, :])
    d1 = torch.sum(f1.normal * f1.centroid, dim=-1)
    d2 = torch.sum(n2t * c2t, dim=-1)
    dist = torch.abs(d1[:, None] - d2[..., None, :])
    cand = (
        f1.valid[:, None]
        & f2.valid[None, :]
        & (ang < params.qv_angle)
        & (dist < params.qv_dist)
    )

    ps1 = f1.point_size[:, None]
    ps2 = f2.point_size[None, :]
    ratio = torch.minimum(ps1, ps2) / torch.clamp(
        torch.maximum(ps1, ps2), min=1e-12
    )
    # First strictly-best candidate per source face (:742-755, strict >):
    # torch.argmax returns the first maximum.
    best_j = torch.argmax(torch.where(cand, ratio, -1.0), dim=-1)
    pair_valid = torch.any(cand, dim=-1) & f1.valid

    min_sz = torch.minimum(f1.point_size, f2.point_size[best_j])
    importance = torch.where(
        pair_valid, 2.0 * min_sz / torch.clamp(size1 + size2, min=1e-12), 0.0
    )
    n_pairs = torch.sum(pair_valid, dim=-1)
    score = torch.sum(importance, dim=-1)
    idx = best_j[..., None].expand(best_j.shape + (3,))
    n2b = torch.gather(n2t, -2, idx)
    c2b = torch.gather(c2t, -2, idx)
    return score, n_pairs, n2b, c2b, importance


def refine_transform(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Re-match under each T (..., 4, 4) and apply the LM refinement
    (T <- dT @ T) where >= required_optimize pairs matched (:772-776)."""
    batch = T.shape[:-2]
    T = T.reshape(-1, 4, 4)
    _, n_pairs, n2b, c2b, importance = match_faces(T, f1, f2, params)
    Bt = T.shape[0]
    F = f1.valid.shape[0]
    do_refine = n_pairs >= params.required_optimize
    # Candidates that keep T do not need a correction: zero weights make
    # their LM lanes inert (see refine_pairs).
    dT = refine_pairs(
        n1=f1.normal.expand(Bt, F, 3),
        p1=f1.centroid.expand(Bt, F, 3),
        n2=n2b,
        p2=c2b,
        w=torch.where(do_refine[:, None], importance, 0.0),
        iters=params.refine_iters,
    )
    out = torch.where(do_refine[:, None, None], dT @ T, T)
    return out.reshape(batch + (4, 4))
