"""Vectorized geometry primitives (port of the main-path parts of
``fccf_pcr_tpu/ops/geometry.py``).

Normal angles, Rodrigues rotations, the closed-form two-step rotation
constructions, quaternion <-> matrix conversions, rigid transforms and
the rotation/translation error metrics. Every function broadcasts over leading
batch dims and follows the JAX expression order, so float32 results agree
with the reference to rounding.
"""

from __future__ import annotations

import math

import torch

from .batch import constant, small_matmul

_EPS = 1e-12


def dot(a, b):
    """Sum over the last axis of a * b."""
    return torch.sum(a * b, dim=-1)


def norm(v):
    return torch.sqrt(dot(v, v))


def cross(a, b):
    """Cross product along the last axis, broadcasting like jnp.cross."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(v, eps=_EPS):
    """Unit vector along last axis; zero vectors map to zero (not NaN)."""
    n = norm(v)[..., None]
    return v / torch.clamp(n, min=eps)


def degrees(x):
    return x * (180.0 / math.pi)


def cos_deg(angle_deg):
    """cos of an angle gate in degrees as a float32 value, computed in
    float32 as the JAX package does (``jnp.cos(jnp.deg2rad(a))``)."""
    a = torch.tensor(angle_deg, dtype=torch.float32)
    return float(torch.cos(torch.deg2rad(a)))


def angle_deg(n1, n2):
    """Angle in degrees between (possibly non-unit) vectors
    (``compute_normal_angel``, FCCF.cpp:369-377), cos clipped to [-1, 1]."""
    num = dot(n1, n2)
    den = norm(n1) * norm(n2)
    cos = torch.clamp(num / torch.clamp(den, min=_EPS), -1.0, 1.0)
    return degrees(torch.arccos(cos))


def skew(v):
    """Cross-product matrix [v]_x, batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def matvec(R, v):
    """R @ v for (..., 3, 3) and (..., 3)."""
    return torch.sum(R * v[..., None, :], dim=-1)


def rodrigues(axis, cos_t, sin_t):
    """R = cos*I + (1-cos)*rr^T + sin*[r]_x with r = axis (unit)."""
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    rrt = axis[..., :, None] * axis[..., None, :]
    return (
        cos_t[..., None, None] * eye
        + (1.0 - cos_t)[..., None, None] * rrt
        + sin_t[..., None, None] * skew(axis)
    )


def _safe_denom(denom):
    return torch.where(
        torch.abs(denom) > _EPS, denom, torch.full_like(denom, _EPS)
    )


def rotation_between_planes(n1, m1, n2, m2):
    """Closed-form R = R2 @ R1 aligning plane pair (n2, m2) -> (n1, m1)
    (``computer_transform``, FCCF.cpp:848-895), raw normals throughout.
    Returns (R, m2_rot) with m2_rot = R1 @ m2 (the reference reuses it)."""
    r1 = normalize(cross(n2, n1))
    cos1 = dot(n2, n1)
    sin1 = dot(cross(r1, n2), n1)
    R1 = rodrigues(r1, cos1, sin1)
    m2r = matvec(R1, m2)

    r2 = n1  # unnormalized in the reference too (FCCF.cpp:873)
    m2dm1 = dot(m2r, m1)
    m2dr2 = dot(m2r, r2)
    m1dr2 = dot(m1, r2)
    denom = _safe_denom(1.0 - m2dr2 * m1dr2)
    cos2 = (m2dm1 - m2dr2 * m1dr2) / denom
    sin2 = dot(cross(r2, m2r), m1) / denom
    R2 = rodrigues(r2, cos2, sin2)
    return small_matmul(R2, R1), m2r


def rotation_from_two_axes(nt1, nt2):
    """R with R@x_hat ~ nt1 and R@y_hat ~ nt2 (FCCF.cpp:1148-1196)."""
    ns1 = constant((1.0, 0.0, 0.0), nt1.dtype, nt1.device).expand(nt1.shape)
    ns2 = constant((0.0, 1.0, 0.0), nt1.dtype, nt1.device).expand(nt1.shape)
    r1 = normalize(cross(ns1, nt1))
    cos1 = dot(nt1, ns1)
    sin1 = dot(nt1, cross(r1, ns1))
    R1 = rodrigues(r1, cos1, sin1)
    ns2r = matvec(R1, ns2)
    r2 = nt1
    ns2dnt2 = dot(ns2r, nt2)
    ns2dr2 = dot(ns2r, r2)
    nt2dr2 = dot(nt2, r2)
    denom = _safe_denom(1.0 - ns2dr2 * nt2dr2)
    cos2 = (ns2dnt2 - ns2dr2 * nt2dr2) / denom
    sin2 = dot(cross(r2, ns2r), nt2) / denom
    R2 = rodrigues(r2, cos2, sin2)
    return small_matmul(R2, R1)


# Quaternions: (w, x, y, z).


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q = (w, x, y, z)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_multiply(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp(n, min=_EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free
    Shepperd form: the best-conditioned of four candidates (first max)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack(
        [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1
    )
    qy = torch.stack(
        [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1
    )
    qz = torch.stack(
        [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1
    )
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    mags = torch.stack(
        [
            1.0 + tr,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    best = torch.argmax(mags, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return normalize(q)


def make_transform(R, t):
    """Assemble a 4x4 homogeneous transform from R (..., 3, 3), t (..., 3)."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rotation_error_deg(R_est, R_gt):
    """Relative rotation error (degrees); the trace is an elementwise dot
    sum, not a matmul."""
    tr = torch.sum(R_gt * R_est, dim=(-2, -1))
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return degrees(torch.arccos(cos))
