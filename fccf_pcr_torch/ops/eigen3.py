"""Batched closed-form symmetric 3x3 eigendecomposition (port of
``fccf_pcr_tpu/ops/eigen3.py``).

Trigonometric eigenvalues (Smith 1961) + smallest eigenvector via the
best-conditioned cross product of rows of (A - lambda_min I). The closed
form itself is ported (not ``torch.linalg.eigh``) so near-degenerate
normals and curvatures follow the reference's arithmetic.
"""

from __future__ import annotations

import math

import torch

from .geometry import cross, norm

_EPS = 1e-20


def eigvals_sym3x3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending (l0 <= l1 <= l2)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.clamp(p, min=_EPS)

    c00, c01, c02 = b00 / p_safe, a01 / p_safe, a02 / p_safe
    c11, c12, c22 = b11 / p_safe, a12 / p_safe, b22 / p_safe
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], dim=-1)


def _eigvec_for(A, lam):
    """Eigenvector for eigenvalue lam: best cross product of rows of A-lam*I."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = cross(r0, r1)
    c02 = cross(r0, r2)
    c12 = cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    cands = torch.stack([c01, c02, c12], dim=-2)
    norms = torch.stack([n01, n02, n12], dim=-1)
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 3))
    v = torch.gather(cands, -2, idx)[..., 0, :]
    nrm = norm(v)[..., None]
    # Degenerate (isotropic) matrix: +z; callers gate on curvature.
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(
        nrm > 1e-12, v / torch.clamp(nrm, min=_EPS), fallback.expand(v.shape)
    )


def plane_fit_from_cov(cov):
    """Smallest eigenpair of a covariance: (normal, curvature), with
    curvature = l0 / (l0 + l1 + l2) (PCL's definition, FCCF.cpp:497);
    a zero covariance gives curvature 0."""
    scale = torch.clamp(
        torch.amax(torch.abs(cov), dim=(-2, -1), keepdim=True), min=_EPS
    )
    covn = cov / scale
    lams = eigvals_sym3x3(covn)
    l0 = lams[..., 0]
    lsum = lams[..., 0] + lams[..., 1] + lams[..., 2]
    curvature = torch.where(
        torch.abs(lsum) > _EPS,
        torch.abs(l0) / torch.clamp(torch.abs(lsum), min=_EPS),
        torch.zeros_like(lsum),
    )
    normal = _eigvec_for(covn, l0)
    return normal, curvature
