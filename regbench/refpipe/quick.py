"""Quick (coarse) verification (port of ``fccf_pcr_tpu/verify/quick.py``;
``quick_verify`` FCCF.cpp:680-783).

Transform the target faces, find coplanar source-target face pairs (angle
< 10 deg and plane-offset difference < 2 m), keep the best candidate per
source face by min/max size ratio, score the sum of pair importances, and
refine the transform when >= 4 pairs matched. Both functions take the
faces of each pair of the leading batch dims (...) and, per pair, a batch
of candidate transforms (..., *candidates, 4, 4), in place of the JAX
package's vmaps.
"""

from __future__ import annotations

import torch

from .config import FCCFParams
from .faces import Faces
from . import geometry
from .batch import small_matmul
from .gauss_newton import refine_pairs


def _candidates(T, faces: Faces):
    """T (*lead, *cand, 4, 4) as (*lead, X, 4, 4), and cand, where lead
    is the faces' batch shape."""
    nl = faces.valid.dim() - 1
    cand = tuple(T.shape[nl:-2])
    return T.reshape(tuple(T.shape[:nl]) + (-1, 4, 4)), cand


def match_faces(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Pair matching + scoring under transforms T (..., *cand, 4, 4)
    (:683-769). Returns (score (..., *cand), n_pairs (..., *cand),
    n2t_best (..., *cand, F, 3), c2t_best (..., *cand, F, 3), importance
    (..., *cand, F)). Pair selection and score use the transform before
    refinement, as in the reference."""
    T, cand = _candidates(T, f1)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    c2t = small_matmul(f2.centroid[..., None, :, :], R.mT) + t[..., None, :]
    n2t = small_matmul(f2.normal[..., None, :, :], R.mT)  # (..., X, F, 3)

    size1 = torch.sum(torch.where(f1.valid, f1.point_size, 0.0), dim=-1)
    size2 = torch.sum(torch.where(f2.valid, f2.point_size, 0.0), dim=-1)

    ang = geometry.angle_deg(f1.normal[..., None, :, None, :],
                             n2t[..., None, :, :])
    d1 = torch.sum(f1.normal * f1.centroid, dim=-1)
    d2 = torch.sum(n2t * c2t, dim=-1)
    dist = torch.abs(d1[..., None, :, None] - d2[..., None, :])
    cand_ok = (
        f1.valid[..., None, :, None]
        & f2.valid[..., None, None, :]
        & (ang < params.qv_angle)
        & (dist < params.qv_dist)
    )  # (..., X, F1, F2)

    ps1 = f1.point_size[..., None, :, None]
    ps2 = f2.point_size[..., None, None, :]
    ratio = torch.minimum(ps1, ps2) / torch.clamp(
        torch.maximum(ps1, ps2), min=1e-12
    )
    # First strictly-best candidate per source face (:742-755, strict >):
    # torch.argmax returns the first maximum.
    best_j = torch.argmax(torch.where(cand_ok, ratio, -1.0), dim=-1)
    pair_valid = torch.any(cand_ok, dim=-1) & f1.valid[..., None, :]

    ps2_best = torch.gather(f2.point_size[..., None, :].expand(best_j.shape),
                            -1, best_j)
    min_sz = torch.minimum(f1.point_size[..., None, :], ps2_best)
    importance = torch.where(
        pair_valid,
        2.0 * min_sz / torch.clamp(size1 + size2, min=1e-12)[..., None, None],
        0.0,
    )
    n_pairs = torch.sum(pair_valid, dim=-1)
    score = torch.sum(importance, dim=-1)
    idx = best_j[..., None].expand(best_j.shape + (3,))
    n2b = torch.gather(n2t, -2, idx)
    c2b = torch.gather(c2t, -2, idx)
    lead = tuple(score.shape[:-1])
    F = f1.valid.shape[-1]
    return (score.reshape(lead + cand), n_pairs.reshape(lead + cand),
            n2b.reshape(lead + cand + (F, 3)), c2b.reshape(lead + cand + (F, 3)),
            importance.reshape(lead + cand + (F,)))


def refine_transform(T, f1: Faces, f2: Faces, params: FCCFParams):
    """Re-match under each T (..., *cand, 4, 4) and apply the LM
    refinement (T <- dT @ T) where >= required_optimize pairs matched
    (:772-776). Every candidate of every pair is one lane of one
    ``refine_pairs`` call."""
    shape = T.shape
    T, _ = _candidates(T, f1)
    _, n_pairs, n2b, c2b, importance = match_faces(T, f1, f2, params)
    F = f1.valid.shape[-1]
    do_refine = (n_pairs >= params.required_optimize).reshape(-1)
    # Candidates that keep T do not need a correction: zero weights make
    # their LM lanes inert (see refine_pairs).
    dT = refine_pairs(
        n1=f1.normal[..., None, :, :].expand(n2b.shape).reshape(-1, F, 3),
        p1=f1.centroid[..., None, :, :].expand(c2b.shape).reshape(-1, F, 3),
        n2=n2b.reshape(-1, F, 3),
        p2=c2b.reshape(-1, F, 3),
        w=torch.where(do_refine[:, None], importance.reshape(-1, F), 0.0),
        iters=params.refine_iters,
    )
    T = T.reshape(-1, 4, 4)
    out = torch.where(do_refine[:, None, None], small_matmul(dT, T), T)
    return out.reshape(shape)
