"""The plain versions of the faces stage's kernels (ops/faces_kernels.py:
F1, the plane fit with its gates and orientation; F2, the label segment
sums in the face-statistics and values forms) against the JAX package on
the CPU, from the same seeded NumPy inputs.

Tolerances as the existing tests': the plane fit, its gates and the
oriented normals exact (the port rounds as XLA compiles the reference on
the CPU; tests/test_torch_ops.py); face statistics rtol 1e-5 / atol 1e-5
and voxel counts exact (the doubling scan adds in another order than the
one-hot contraction; tests/test_torch_faces.py). A row of a batch of 4
equals that row alone bit for bit. The kernels themselves run only on a
card (tests/test_torch_cuda.py holds them to these plain versions)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fccf_pcr_tpu.features import faces as jfaces
from fccf_pcr_tpu.ops import eigen3 as jeig
from fccf_pcr_torch.ops import faces_kernels as fk

POINT_THRESHOLD = 5
CURVATURE_THRESHOLD = 0.04
_BIG = 2**30


def _covariances(rng, n):
    """Random planar and non-planar covariances, with zero, isotropic,
    rank-1 ones and -0.0 off-diagonals around a negative eigenvalue."""
    R = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    ev = rng.uniform(0.01, 1.0, (n, 3))
    ev[: n // 2, 0] = rng.uniform(1e-6, 1e-3, n // 2)
    cov = np.einsum("nij,nj,nkj->nik", R, ev, R).astype(np.float32)
    kinds = rng.integers(0, 8, n)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    cov[kinds == 0] = 0.0
    cov[kinds == 1] = np.eye(3, dtype=np.float32) * np.float32(0.5)
    for i in np.flatnonzero(kinds == 2):
        cov[i] = np.outer(u[i], u[i])
    for i in np.flatnonzero(kinds == 3):
        cov[i] = np.diag(rng.uniform(-1.0, 1.0, 3)).astype(np.float32)
        cov[i][~np.eye(3, dtype=bool)] = -0.0
    return cov


def plane_inputs(B, V, seed):
    """(cov, centroid, count, valid, global centroid) of B clouds of V
    voxels: counts around the threshold, invalid voxels."""
    rng = np.random.default_rng(seed)
    return (_covariances(rng, B * V).reshape(B, V, 3, 3),
            rng.uniform(-5, 5, (B, V, 3)).astype(np.float32),
            rng.integers(0, 12, (B, V)).astype(np.int32),
            rng.uniform(size=(B, V)) < 0.8,
            rng.uniform(-1, 1, (B, 3)).astype(np.float32))


def _jax_plane_fit(cov, centroid, count, valid, gcent):
    """The JAX package's plane fit, gates and orientation
    (fccf_pcr_tpu/features/faces.py:260-283)."""
    normal, curvature = jeig.plane_fit_from_cov(cov)
    enough = count > POINT_THRESHOLD
    planar = curvature < CURVATURE_THRESHOLD
    to_c = centroid - gcent[None, :]
    flip = jnp.sum(to_c * normal, axis=-1) < 0.0
    return (jnp.where(flip[:, None], normal, -normal), curvature,
            valid & enough & planar, valid & enough & ~planar)


def _plane_fit(*args):
    return fk.plane_fit(*args, POINT_THRESHOLD, CURVATURE_THRESHOLD)


@pytest.mark.parametrize("B,V", [(1, 1), (3, 257)])
def test_plane_fit_plain_matches_jax(B, V):
    args = plane_inputs(B, V, V)
    j = jax.jit(jax.vmap(_jax_plane_fit))(*(jnp.asarray(a) for a in args))
    t = _plane_fit(*(torch.from_numpy(a) for a in args))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def stat_inputs(B, V, seed, kind):
    """(labels, valid, count, centroid, normal): component-min labels
    ("random"), one-voxel faces ("singletons"), one face of every voxel
    ("one") or labels past V ("wide"); invalid rows labelled 2^30; counts
    of 0 in places, so negative coordinates give -0.0 columns."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(B, V)) < 0.8
    if kind == "random":
        labels = np.minimum(rng.integers(0, max(V // 7, 1), (B, V)),
                            np.arange(V))
    elif kind == "singletons":
        labels = np.broadcast_to(np.arange(V), (B, V)).copy()
    elif kind == "one":
        labels = np.zeros((B, V), np.int64)
        valid[:] = True
    else:
        labels = rng.integers(0, 2 * V, (B, V))
    labels = np.where(valid, labels, _BIG).astype(np.int64)
    centroid = rng.normal(size=(B, V, 3)).astype(np.float32) * 10.0
    normal = rng.normal(size=(B, V, 3)).astype(np.float32)
    for a in (centroid, normal):
        a[rng.uniform(size=a.shape) < 0.05] = -0.0
    return (labels, valid, rng.integers(0, 40, (B, V)).astype(np.int32),
            centroid, normal)


STAT_CASES = [(1, 1, "random"), (1, 1, "one"), (2, 300, "random"),
              (2, 300, "singletons"), (1, 257, "one"), (2, 300, "wide"),
              (1, 512, "random")]


@pytest.mark.parametrize("B,V,kind", STAT_CASES)
def test_face_stats_plain_matches_jax(B, V, kind):
    args = stat_inputs(B, V, B * V, kind)
    jfn = jax.jit(jax.vmap(functools.partial(jfaces._face_stats, V=V)))
    j = jfn(*(jnp.asarray(a) for a in args))
    t = fk.face_stats(*(torch.from_numpy(a) for a in args), V)
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


@pytest.mark.parametrize("B,V,kind", STAT_CASES)
def test_segment_sum_plain_matches_jax(B, V, kind):
    labels, valid, _, centroid, _ = stat_inputs(B, V, B + V, kind)
    values = np.abs(centroid[..., 0])
    jfn = jax.jit(jax.vmap(functools.partial(jfaces._label_segment_sum,
                                             V=V)))
    j = jfn(jnp.asarray(values), jnp.asarray(labels), jnp.asarray(valid))
    t = fk.label_segment_sum(torch.from_numpy(values),
                             torch.from_numpy(labels),
                             torch.from_numpy(valid), V)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def _assert_rows_alone(fn, args, n=4):
    """fn on a batch of n rows, each output row bit for bit fn of that
    row alone."""
    full = fn(*args)
    for k in range(n):
        alone = fn(*(a[k:k + 1] for a in args))
        for x, y in zip(full, alone):
            assert x.dtype == y.dtype and torch.equal(x[k:k + 1], y), k


def test_rows_sum_alike_alone_and_in_a_batch():
    _assert_rows_alone(_plane_fit, [torch.from_numpy(a)
                                    for a in plane_inputs(4, 300, 1)])
    for kind in ("random", "singletons"):
        labels, valid, count, centroid, normal = (
            torch.from_numpy(a) for a in stat_inputs(4, 300, 2, kind))
        _assert_rows_alone(lambda *a: fk.face_stats(*a, 300),
                           (labels, valid, count, centroid, normal))
        _assert_rows_alone(
            lambda v, lab, val: (fk.label_segment_sum(v, lab, val, 300),),
            (centroid[..., 0], labels, valid))


def test_segment_sum_keeps_the_scans_signed_zeros():
    """The sums are the doubling scan's: its +0.0 adds turn a -0.0 into
    +0.0 on every row they reach, so only a label whose one row is the
    first of the sorted rows keeps -0.0; slots without a row are +0.0
    and rows labelled past the slots are dropped."""
    V = 5
    values = torch.full((1, V), -0.0)
    labels = torch.tensor([[0, 1, 1, 3, 9]])
    valid = torch.tensor([[True, True, True, True, False]])
    got = fk.label_segment_sum(values, labels, valid, V)
    assert torch.equal(got, torch.zeros(1, V))
    assert torch.signbit(got).tolist() == [[True, False, False, False,
                                            False]]


def test_cpu_calls_build_nothing_and_other_devices_raise():
    args = [torch.from_numpy(a) for a in plane_inputs(1, 8, 3)]
    kept = fk._LIBRARY._lib, fk.PLANE_FITS, fk.SEGMENT_SUMS
    _plane_fit(*args)
    fk.face_stats(*(torch.from_numpy(a) for a in stat_inputs(1, 8, 3,
                                                             "random")), 8)
    assert (fk._LIBRARY._lib, fk.PLANE_FITS, fk.SEGMENT_SUMS) == kept
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        _plane_fit(*meta)
