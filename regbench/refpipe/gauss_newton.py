"""Plane-to-plane pose refinement by Levenberg-Marquardt (port of
``fccf_pcr_tpu/refine/gauss_newton.py``, replacing Ceres FCCF.cpp:178-249).

Minimizes sum_i w_i^2 (|n1 x (Q n2)|^2 + (n1.p1 - (Q n2).(Q p2 + t))^2)
over (quaternion, translation) with a left-multiplied so(3) tangent step.
The JAX package vmaps a ``lax.while_loop``; here the candidates are a
batch dimension and every lane follows the batched while-loop semantics
exactly: a lane iterates until it is done or at its iteration cap, and a
finished lane's q, t, lam and iteration count stay frozen.

``refine_pairs`` is ``lm_loop``, the loop as PyTorch ops, which stops
once no lane can move (one host read an iteration): the plain version of
the port's LM kernel L1.
"""

from __future__ import annotations

import torch

from . import geometry
from .batch import constant, fold_sum
from .linalg6 import solve_spd6


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


def _residual_terms(q, t, n1, n1p1, n2, p2, w):
    """The weighted residuals (Bt, P, 4) at (q, t), masked pairs carrying
    w = 0, and what the Jacobian reuses: v = (n2, p2) on one axis
    (Bt, 2P, 3), quat_rotate's u x v, the rotated normals n2r and the
    moved points p2r. ``n1p1`` is n1 . p1, which does not depend on the
    pose. The rotation is ``geometry.quat_rotate``'s expression."""
    P = n1.shape[1]
    v = torch.cat([n2, p2], dim=1)
    u = q[:, None, 1:]
    uv = geometry.cross(u, v)
    rot = v + 2.0 * (q[:, None, :1] * uv + geometry.cross(u, uv))
    n2r, p2r = rot[:, :P], rot[:, P:] + t[:, None, :]
    crs = geometry.cross(n1, n2r)
    off = n1p1 - torch.sum(n2r * p2r, dim=-1)
    r = torch.cat([crs, off[..., None]], dim=-1) * w[..., None]
    return r, v, uv, n2r, p2r


# The tangent of exp(v) * q at v = 0 along v = e_k (k = 0, 1, 2): the
# tangent of _exp_quat there is exactly (0, e_k / 2), and quat_multiply
# turns it into q's components in this order with these signs (exact).
_DQ_INDEX = ((1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_DQ_SIGN = ((-0.5, 0.5, -0.5, 0.5), (-0.5, 0.5, 0.5, -0.5),
            (-0.5, -0.5, 0.5, 0.5))


# cross(a, b)[c] = a[R1] b[R2] - a[R2] b[R1], R1 = [1, 2, 0], R2 = [2, 0, 1],
# as rolls: indexing with a list copies it to the card, a host sync.
def _r1(x):
    return torch.roll(x, -1, dims=-1)


def _r2(x):
    return torch.roll(x, 1, dims=-1)


def _cross_tangent(a, da, b, db):
    """Tangent of cross(a, b) as forward-mode AD forms it: each product
    gives da * b + a * db, and the two products are then subtracted."""
    return ((_r1(da) * _r2(b) + _r1(a) * _r2(db))
            - (_r2(da) * _r1(b) + _r2(a) * _r1(db)))


def _residuals_and_jacobian(q, t, n1, n1p1, n2, p2, w):
    """The weighted residuals (Bt, 4P) at (q, t) and their (Bt, 4P, 6)
    Jacobian w.r.t. the local step delta = (v, dt) at delta = 0, where
    q' = exp(v) * q and t' = t + dt.

    The chain rule is written out in the reference's operand order
    (``jax.jacfwd(local_residual)``: _exp_quat -> quat_multiply ->
    quat_rotate -> cross, offset, weight), so it rounds as forward-mode
    AD does. The three rotation directions ride on one axis; along a
    translation direction every rotation tangent is zero and the
    residual's tangent is (0, 0, 0, -n2r_k) * w exactly."""
    Bt, P, _ = n1.shape
    r, v, uv, n2r, p2r = _residual_terms(q, t, n1, n1p1, n2, p2, w)
    wq, u = q[:, None, None, :1], q[:, None, None, 1:]   # (Bt, 1, 1, .)

    sign = constant(_DQ_SIGN, q.dtype, q.device)
    dq = (q[:, constant(_DQ_INDEX, torch.long, q.device)] * sign)[:, :, None, :]
    dw, du = dq[..., :1], dq[..., 1:]
    uv3 = uv[:, None]
    duv = geometry.cross(du, v[:, None])                 # (Bt, 3, 2P, 3)
    drot = 2.0 * ((dw * uv3 + wq * duv)
                  + _cross_tangent(u, du, uv3, duv))
    dn2r, dp2r = drot[:, :, :P], drot[:, :, P:]
    dcrs = geometry.cross(n1[:, None], dn2r)
    doff = -torch.sum(dn2r * p2r[:, None] + n2r[:, None] * dp2r, dim=-1)
    d_rot = torch.cat([dcrs, doff[..., None]], dim=-1) * w[:, None, :, None]

    J = torch.zeros((Bt, P, 4, 6), dtype=q.dtype, device=q.device)
    J[..., :3] = d_rot.permute(0, 2, 3, 1)
    J[:, :, 3, 3:] = -n2r * w[..., None]
    return r.flatten(1), J.flatten(1, 2)


def refine_pairs(n1, p1, n2, p2, w, iters: int = 50):
    """LM solve for the corrections DeltaT of a batch of candidates.

    n1, p1, n2, p2: (Bt, P, 3) plane normals/points of matched pairs;
    w: (Bt, P) per-pair weights (0 for masked slots). Returns (Bt, 4, 4)
    corrections, to be composed T <- DeltaT @ T (FCCF.cpp:775), by
    ``lm_loop`` with its early exit.
    """
    return lm_loop(n1, p1, n2, p2, w, iters)


def lm_loop(n1, p1, n2, p2, w, iters: int = 50, early_exit: bool = True):
    """The eager LM loop of ``refine_pairs`` on the CPU, and the plain
    version of the kernel L1 on a card (which nothing on the card's main
    path calls). ``early_exit`` stops once no lane can move, at the cost
    of one host read an iteration; without it the loop runs exactly
    ``iters`` iterations and reads nothing back (so a CUDA graph can
    capture it). A lane at zero (or NaN) cost can never accept a step
    (``c_new < c_old`` is false), so its q and t are final: once every
    other lane is done the remaining iterations change only lam, and both
    forms return the same bits."""
    Bt = n1.shape[0]
    dt = p1.dtype
    dev = p1.device
    q = constant((1.0, 0.0, 0.0, 0.0), dt, dev).repeat(Bt, 1)
    t = torch.zeros((Bt, 3), dtype=dt, device=dev)
    lam = torch.full((Bt,), 1e-4, dtype=dt, device=dev)
    it = torch.zeros((Bt,), dtype=torch.int32, device=dev)
    done = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    n1p1 = torch.sum(n1 * p1, dim=-1)

    for _ in range(iters):
        active = ~done & (it < iters)
        r, J = _residuals_and_jacobian(q, t, n1, n1p1, n2, p2, w)
        # The costs, J^T J and J^T r as fixed pairwise sums over the
        # residuals, so a lane rounds alike in every batch.
        c_old = fold_sum(r * r, dim=-1)
        if early_exit and not bool(torch.any(active & (c_old > 0))):
            break  # one host sync
        JtJ = fold_sum(J[..., :, None] * J[..., None, :], dim=1)
        g = fold_sum(J * r[..., None], dim=1)
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
        r_new = _residual_terms(q_new, t_new, n1, n1p1, n2, p2, w)[0].flatten(1)
        c_new = fold_sum(r_new * r_new, dim=-1)
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
