"""Port ops (geometry, eigen3, linalg6, metrics, sorting) against the JAX
functions on identical numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-6 (float32; the two frameworks' trig
and reduction kernels may differ by a few ulp); plane-fit normals atol
1e-5 (see test_op_matches_jax)."""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fccf_pcr_tpu.ops import eigen3 as jeig
from fccf_pcr_tpu.ops import geometry as jgeo
from fccf_pcr_tpu.ops import linalg6 as jlin
from fccf_pcr_tpu.pipeline import metrics as jmet
from fccf_pcr_torch.ops import eigen3 as teig
from fccf_pcr_torch.ops import geometry as tgeo
from fccf_pcr_torch.ops import linalg6 as tlin
from fccf_pcr_torch.ops import sorting as tsort
from fccf_pcr_torch.pipeline import metrics as tmet

RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _rotations(rng, n):
    return np.asarray(jgeo.quat_to_matrix(jnp.asarray(_quats(rng, n))))


def _both(jfn, tfn, *args):
    j = jfn(*[jnp.asarray(a) for a in args])
    t = tfn(*[torch.from_numpy(np.array(a)) for a in args])
    return j, t


def _close(j, t, rtol=RTOL, atol=ATOL):
    if isinstance(j, tuple):
        for a, b in zip(j, t):
            _close(a, b, rtol, atol)
        return
    np.testing.assert_allclose(
        np.asarray(t.numpy(), np.float64), np.asarray(j, np.float64),
        rtol=rtol, atol=atol,
    )


def _case_normalize(rng):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0
    return jgeo.normalize, tgeo.normalize, (v,)


def _case_angle(rng):
    return jgeo.angle_deg, tgeo.angle_deg, (
        rng.normal(size=(64, 3)).astype(np.float32),
        rng.normal(size=(64, 3)).astype(np.float32),
    )


def _case_rodrigues(rng):
    th = rng.uniform(-3, 3, 32).astype(np.float32)
    return jgeo.rodrigues, tgeo.rodrigues, (
        _unit(rng, 32), np.cos(th), np.sin(th)
    )


def _case_rotation_between_planes(rng):
    n1, m1, n2, m2 = (_unit(rng, 32) * 0.98 for _ in range(4))
    return jgeo.rotation_between_planes, tgeo.rotation_between_planes, (
        n1, m1, n2, m2
    )


def _case_rotation_from_two_axes(rng):
    R = _rotations(rng, 32)
    return jgeo.rotation_from_two_axes, tgeo.rotation_from_two_axes, (
        R[:, :, 0].copy(), R[:, :, 1].copy()
    )


def _case_quat_rotate(rng):
    return jgeo.quat_rotate, tgeo.quat_rotate, (
        _quats(rng, 32), rng.normal(size=(32, 3)).astype(np.float32)
    )


def _case_quat_multiply(rng):
    return jgeo.quat_multiply, tgeo.quat_multiply, (
        _quats(rng, 32), _quats(rng, 32)
    )


def _case_quat_to_matrix(rng):
    return jgeo.quat_to_matrix, tgeo.quat_to_matrix, (_quats(rng, 32),)


def _case_matrix_to_quat(rng):
    return jgeo.matrix_to_quat, tgeo.matrix_to_quat, (_rotations(rng, 64),)


def _case_make_transform(rng):
    return jgeo.make_transform, tgeo.make_transform, (
        _rotations(rng, 8), rng.normal(size=(8, 3)).astype(np.float32)
    )


def _case_rotation_error(rng):
    return jgeo.rotation_error_deg, tgeo.rotation_error_deg, (
        _rotations(rng, 32), _rotations(rng, 32)
    )


def _case_registration_errors(rng):
    T1 = np.asarray(jgeo.make_transform(
        jnp.asarray(_rotations(rng, 8)),
        jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32)),
    ))
    T2 = np.asarray(jgeo.make_transform(
        jnp.asarray(_rotations(rng, 8)),
        jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32)),
    ))
    return jmet.registration_errors, tmet.registration_errors, (T1, T2)


def _random_covs(rng, n, planar=False):
    out = []
    for _ in range(n):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        ev = rng.uniform(0.01, 1.0, 3)
        if planar:
            ev[0] = rng.uniform(1e-5, 1e-3)
        out.append(R @ np.diag(ev) @ R.T)
    return np.asarray(out, np.float32)


def _case_eigvals(rng):
    return jeig.eigvals_sym3x3, teig.eigvals_sym3x3, (_random_covs(rng, 64),)


def _case_plane_fit(rng):
    covs = np.concatenate(
        [_random_covs(rng, 64), _random_covs(rng, 64, planar=True),
         np.zeros((1, 3, 3), np.float32)]
    )
    return jeig.plane_fit_from_cov, teig.plane_fit_from_cov, (covs,)


def _case_solve_spd6(rng):
    A = rng.normal(size=(32, 6, 6))
    A = (A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6)).astype(np.float32)
    return jlin.solve_spd6, tlin.solve_spd6, (
        A, rng.normal(size=(32, 6)).astype(np.float32)
    )


CASES = {
    "normalize": _case_normalize,
    "angle_deg": _case_angle,
    "rodrigues": _case_rodrigues,
    "rotation_between_planes": _case_rotation_between_planes,
    "rotation_from_two_axes": _case_rotation_from_two_axes,
    "quat_rotate": _case_quat_rotate,
    "quat_multiply": _case_quat_multiply,
    "quat_to_matrix": _case_quat_to_matrix,
    "matrix_to_quat": _case_matrix_to_quat,
    "make_transform": _case_make_transform,
    "rotation_error_deg": _case_rotation_error,
    "registration_errors": _case_registration_errors,
    "eigvals_sym3x3": _case_eigvals,
    "plane_fit_from_cov": _case_plane_fit,
    "solve_spd6": _case_solve_spd6,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    jfn, tfn, args = CASES[name](_rng(zlib.crc32(name.encode())))
    j, t = _both(jfn, tfn, *args)
    if name == "plane_fit_from_cov":
        # The normal of a near-planar covariance moves by (one ulp of the
        # smallest eigenvalue) / (eigenvalue gap), ~1e-6 here: XLA lowers
        # acos through atan2 and contracts products into FMAs.
        _close(j[0], t[0], atol=1e-5)
        _close(j[1], t[1])
    else:
        _close(j, t)


def test_solve_spd6_solves():
    rng = _rng(5)
    A = rng.normal(size=(16, 6, 6))
    A = A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6)
    x = rng.normal(size=(16, 6))
    b = np.einsum("bij,bj->bi", A, x)
    got = tlin.solve_spd6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, x, rtol=1e-8, atol=1e-8)


def test_cosort_is_stable_lexicographic():
    rng = _rng(6)
    k1 = torch.from_numpy(rng.integers(0, 4, 500).astype(np.int32))
    k2 = torch.from_numpy(rng.integers(0, 4, 500).astype(np.int32))
    payload = torch.arange(500)
    s1, s2, p = tsort.cosort((k1, k2), (payload,))
    want = np.lexsort((np.arange(500), k2.numpy(), k1.numpy()))
    np.testing.assert_array_equal(p.numpy(), want)
    np.testing.assert_array_equal(s1.numpy(), k1.numpy()[want])
    np.testing.assert_array_equal(s2.numpy(), k2.numpy()[want])
