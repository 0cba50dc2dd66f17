"""Plane-to-plane pose refinement by Levenberg-Marquardt (port of
``fccf_pcr_tpu/refine/gauss_newton.py``, replacing Ceres FCCF.cpp:178-249).

Minimizes sum_i w_i^2 (|n1 x (Q n2)|^2 + (n1.p1 - (Q n2).(Q p2 + t))^2)
over (quaternion, translation) with a left-multiplied so(3) tangent step.
The JAX package vmaps a ``lax.while_loop``; here the candidates are a
batch dimension and every lane follows the batched while-loop semantics
exactly: a lane iterates until it is done or at its iteration cap, and a
finished lane's q, t, lam and iteration count stay frozen.
"""

from __future__ import annotations

import torch

from ..ops import geometry
from ..ops.linalg6 import solve_spd6


def _exp_quat(v):
    """so(3) tangent (..., 3) -> unit quaternion (w, x, y, z); the norm
    goes through a double where so forward-mode AD at v = 0 is finite."""
    t2 = torch.sum(v * v, dim=-1)
    small = t2 < 1e-12
    t2_safe = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2_safe)
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * theta) / theta)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * theta))
    return torch.cat([w[..., None], k[..., None] * v], dim=-1)


def _residuals(q, t, n1, p1, n2, p2, w):
    """(..., P, 4) weighted residuals; masked pairs carry w = 0."""
    n2r = geometry.quat_rotate(q[..., None, :], n2)
    p2r = geometry.quat_rotate(q[..., None, :], p2) + t[..., None, :]
    crs = geometry.cross(n1, n2r)
    off = torch.sum(n1 * p1, dim=-1) - torch.sum(n2r * p2r, dim=-1)
    r = torch.cat([crs, off[..., None]], dim=-1)
    return r * w[..., None]


def _jacobian(q, t, n1, n2, w):
    """(Bt, 4P, 6) Jacobian of the residuals w.r.t. the local step
    delta = (v, dt) at delta = 0 (the JAX package's jacfwd, written out).

    With q' = exp(v) * q, d(R' x)/dv = -[R x]_x, so per pair, scaled by w:
      d(n1 x n2r)/dv = (n1 . n2r) I - n2r n1^T,   d(n1 x n2r)/dt = 0,
      d(offset)/dv   = -(n2r x t),                d(offset)/dt   = -n2r.
    """
    n2r = geometry.quat_rotate(q[:, None, :], n2)  # (Bt, P, 3)
    eye = torch.eye(3, dtype=n2r.dtype, device=n2r.device)
    d_cross = (
        geometry.dot(n1, n2r)[..., None, None] * eye
        - n2r[..., :, None] * n1[..., None, :]
    )  # (Bt, P, 3, 3)
    d_off = torch.cat(
        [-geometry.cross(n2r, t[:, None, :]), -n2r], dim=-1
    )  # (Bt, P, 6)
    rows = torch.cat(
        [torch.cat([d_cross, torch.zeros_like(d_cross)], dim=-1),
         d_off[..., None, :]],
        dim=-2,
    )  # (Bt, P, 4, 6)
    return (rows * w[..., None, None]).flatten(1, 2)


def refine_pairs(n1, p1, n2, p2, w, iters: int = 50):
    """LM solve for the corrections DeltaT of a batch of candidates.

    n1, p1, n2, p2: (Bt, P, 3) plane normals/points of matched pairs;
    w: (Bt, P) per-pair weights (0 for masked slots). Returns (Bt, 4, 4)
    corrections, to be composed T <- DeltaT @ T (FCCF.cpp:775).
    """
    Bt = n1.shape[0]
    dt = p1.dtype
    dev = p1.device
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt, device=dev).repeat(Bt, 1)
    t = torch.zeros((Bt, 3), dtype=dt, device=dev)
    lam = torch.full((Bt,), 1e-4, dtype=dt, device=dev)
    it = torch.zeros((Bt,), dtype=torch.int32, device=dev)
    done = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residual(q, t):
        return _residuals(q, t, n1, p1, n2, p2, w).flatten(-2)

    for _ in range(iters):
        active = ~done & (it < iters)
        r = residual(q, t)
        c_old = torch.sum(r * r, dim=-1)
        # A lane at zero cost can never accept a step (c_new < 0), so its
        # q and t are final: the loop may stop once every other lane is
        # done, with outputs identical to running it to the cap.
        if not bool(torch.any(active & (c_old > 0))):  # one host sync
            break
        J = _jacobian(q, t, n1, n2, w)
        JtJ = J.mT @ J
        g = (J.mT @ r[..., None])[..., 0]
        damped = (
            JtJ
            + lam[:, None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1))
            + 1e-12 * eye6
        )
        delta = -solve_spd6(damped, g)
        q_new = geometry.normalize(
            geometry.quat_multiply(_exp_quat(delta[:, :3]), q)
        )
        t_new = t + delta[:, 3:]
        r_new = residual(q_new, t_new)
        c_new = torch.sum(r_new * r_new, dim=-1)
        accept = c_new < c_old
        # Ceres-style function_tolerance termination (relative 1e-6).
        stop = accept & (
            c_old - c_new <= 1e-6 * torch.clamp(c_old, min=1e-30)
        )
        q_s = torch.where(accept[:, None], q_new, q)
        t_s = torch.where(accept[:, None], t_new, t)
        lam_s = torch.where(
            accept,
            torch.clamp(lam / 3.0, min=1e-10),
            torch.clamp(lam * 2.0, max=1e8),
        )
        # Frozen lanes keep their state, as under a batched while_loop.
        q = torch.where(active[:, None], q_s, q)
        t = torch.where(active[:, None], t_s, t)
        lam = torch.where(active, lam_s, lam)
        done = torch.where(active, stop, done)
        it = it + active.to(torch.int32)
    return geometry.make_transform(geometry.quat_to_matrix(q), t)
