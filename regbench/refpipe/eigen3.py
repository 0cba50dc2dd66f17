"""Batched closed-form symmetric 3x3 eigendecomposition (port of
``fccf_pcr_tpu/ops/eigen3.py``).

Trigonometric eigenvalues (Smith 1961) + smallest eigenvector via the
best-conditioned cross product of rows of (A - lambda_min I). The closed
form itself is ported (not ``torch.linalg.eigh``) so near-degenerate
normals and curvatures follow the reference's arithmetic.

On a near-degenerate voxel (two small, close eigenvalues) one ulp in the
smallest eigenvalue moves the normal by up to ~0.04, so the float32
operations are those XLA compiles the reference into on the CPU:

  - divisions by the constants 3, 6 and 2 are multiplies by their float32
    reciprocals, and ``3 * q`` folds back into the trace;
  - ``acos(r)`` is ``atan2(sqrt((1 - r)(1 + r)), r)``;
  - a product feeding an add or subtract is contracted into one fused
    multiply-add where LLVM contracts it: the first operand's product,
    if that product has no other use in its fusion. So the smallest
    eigenvalue rounds one way for the curvature and another for the
    eigenvector, as in the reference;
  - sqrt is correctly rounded, and cos and atan2 are the C library's
    ``cosf`` / ``atan2f``, which XLA's CPU backend calls.

On the card, cos and atan2 are CUDA's and may differ in the last bit.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

from .batch import constant

_EPS = 1e-20
_THIRD = float(np.float32(1.0) / np.float32(3.0))
_SIXTH = float(np.float32(1.0) / np.float32(6.0))
_TWO_PI_3 = float(np.float32(2.0 * math.pi / 3.0))

_libm = None


def _c_math():
    """The C library's float32 cosf / atan2f as numpy ufuncs."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.cosf.argtypes = [ctypes.c_float]
        lib.cosf.restype = ctypes.c_float
        lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.atan2f.restype = ctypes.c_float
        _libm = (np.frompyfunc(lib.cosf, 1, 1), np.frompyfunc(lib.atan2f, 2, 1))
    return _libm


def _cos(x):
    if x.device.type != "cpu":
        return torch.cos(x)
    out = _c_math()[0](x.numpy().astype(np.float64))
    return torch.from_numpy(np.asarray(out, np.float32))


def _atan2(y, x):
    if x.device.type != "cpu":
        return torch.atan2(y, x)
    out = _c_math()[1](y.numpy().astype(np.float64), x.numpy().astype(np.float64))
    return torch.from_numpy(np.asarray(out, np.float32))


def _sqrt(x):
    """Correctly rounded float32 sqrt (exact through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _fma(a, b, c):
    """a * b + c with one float32 rounding (float32 a, b, c; b may be a
    float32-exact Python float): a * b is exact in float64."""
    b = b.double() if torch.is_tensor(b) else b
    return (a.double() * b + c).to(a.dtype)


def _sum_sq(x, y, z):
    """x^2 + y^2 + z^2 as a contracted sum of squares."""
    return _fma(z, z, _fma(y, y, x * x))


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [_fma(ay, bz, -(az * by)), _fma(az, bx, -(ax * bz)),
         _fma(ax, by, -(ay * bx))],
        dim=-1,
    )


def _trig_form(A):
    """(trace, q, 2p, acos(r)) of the trigonometric closed form."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    trace = (a00 + a11) + a22
    q = trace * _THIRD
    b00 = _fma(-trace, _THIRD, a00)
    b11 = _fma(-trace, _THIRD, a11)
    b22 = _fma(-trace, _THIRD, a22)
    p2 = _sum_sq(b11, b00, b22) + _sum_sq(a02, a01, a12) * 2.0
    p = _sqrt(torch.clamp(p2 * _SIXTH, min=0.0))
    p_safe = torch.clamp(p, min=_EPS)

    # det(B / p) for B = A - q I.
    c00, c01, c02 = b00 / p_safe, a01 / p_safe, a02 / p_safe
    c11, c12, c22 = b11 / p_safe, a12 / p_safe, b22 / p_safe
    m0 = _fma(c11, c22, -(c12 * c12))
    m1 = _fma(c01, c22, -(c12 * c02))
    m2 = _fma(c01, c12, -(c11 * c02))
    det = _fma(c02, m2, _fma(c00, m0, -(c01 * m1)))
    r = torch.clamp(det * 0.5, -1.0, 1.0)
    acos_r = _atan2(_sqrt((1.0 - r) * (r + 1.0)), r)
    return trace, q, p * 2.0, acos_r


def _eigvals(trace, q, two_p, acos_r):
    phi = acos_r * _THIRD
    l0 = _fma(two_p, _cos(phi + _TWO_PI_3), q)
    l2 = _fma(two_p, _cos(phi), q)
    l1 = (trace - l0) - l2
    return l0, l1, l2




def _eigvec_for(A, lam):
    """Eigenvector for eigenvalue lam: best cross product of rows of A-lam*I."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    norms = _sum_sq(cands[..., 0], cands[..., 1], cands[..., 2])
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 3))
    v = torch.gather(cands, -2, idx)[..., 0, :]
    nrm = _sqrt(_sum_sq(v[..., 0], v[..., 1], v[..., 2]))[..., None]
    # Degenerate (isotropic) matrix: +z; callers gate on curvature.
    fallback = constant((0.0, 0.0, 1.0), A.dtype, A.device)
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
    trace, q, two_p, acos_r = _trig_form(covn)
    l0, l1, l2 = _eigvals(trace, q, two_p, acos_r)
    lsum = (l0 + l1) + l2
    curvature = torch.where(
        torch.abs(lsum) > _EPS,
        torch.abs(l0) / torch.clamp(torch.abs(lsum), min=_EPS),
        torch.zeros_like(lsum),
    )
    # The eigenvector's copy of l0: there the phase and the trace's third
    # have one use each, so both contract.
    l0_vec = _fma(
        trace, _THIRD, two_p * _cos(_fma(acos_r, _THIRD, _TWO_PI_3))
    )
    normal = _eigvec_for(covn, l0_vec)
    return normal, curvature
