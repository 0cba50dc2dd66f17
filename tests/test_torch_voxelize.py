"""Port voxelization (downsample_and_voxelize in both layouts,
voxel_stats, voxel_grid_downsample, compact, pre_downsample) against the
JAX functions on identical inputs.

Exact: keys, masks, counts, point_voxel, voxel_start, overflow flags; the
two-key layout and voxel_stats bit for bit, statistics included.
Float32 centroids, covariances and down points: atol 1e-5 (the port's
prefix sums use the reference's association, so in practice they agree
to the last bit or two)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fccf_pcr_tpu.ops import voxelize as jvox
from fccf_pcr_tpu.pipeline.register import pre_downsample as jpre
from fccf_pcr_torch import interop
from fccf_pcr_torch.ops import voxelize as tvox
from fccf_pcr_torch.pipeline.register import pre_downsample as tpre

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, n=6000, cap=8192, extent=12.0):
    rng = np.random.default_rng(seed)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.uniform(-extent / 2, extent / 2, (n, 3)).astype(np.float32)
    mask = np.arange(cap) < n
    return pts, mask


def _assert_stats(j, t):
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert bool(t.overflow) == bool(j.overflow)
    np.testing.assert_allclose(t.centroid.numpy(), np.asarray(j.centroid), atol=ATOL)
    np.testing.assert_allclose(t.cov.numpy(), np.asarray(j.cov), atol=ATOL)


def _check_fused(pts, mask, leaf, face, V):
    jo = jax.jit(
        lambda p, m: jvox.downsample_and_voxelize(p, m, leaf, face, V)
    )(pts, mask)
    to = tvox.downsample_and_voxelize(_t(pts), _t(mask), leaf, face, V)
    jd, jdm, jvs, jpv, jvst = jo
    td, tdm, tvs, tpv, tvst = to
    np.testing.assert_array_equal(tdm.numpy(), np.asarray(jdm))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    np.testing.assert_array_equal(tvst.numpy(), np.asarray(jvst))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    _assert_stats(jvs, tvs)
    return jvs


@pytest.mark.parametrize("seed", [0, 1])
def test_downsample_and_voxelize_random(seed):
    pts, mask = _scene(seed)
    _check_fused(pts, mask, 0.25, 1.0, 1024)


def test_downsample_and_voxelize_pair_cloud(small_pair, params, caps):
    src_p, src_m, tar_p, tar_m, _ = small_pair
    for pts, mask in ((src_p, src_m), (tar_p, tar_m)):
        vs = _check_fused(pts, mask, params.leaf_size, params.face_voxel_size,
                          caps.max_voxels)
        assert int(np.asarray(vs.valid).sum()) > 50


def test_downsample_and_voxelize_voxel_overflow():
    """More occupied voxels than V: the flag and every kept slot match."""
    pts, mask = _scene(2, n=4000, extent=20.0)
    vs = _check_fused(pts, mask, 0.25, 1.0, 256)
    assert bool(vs.overflow)


def test_downsample_and_voxelize_extent_overflow():
    """A cloud wider than the single-key face-cell budget clips and flags."""
    pts, mask = _scene(3, n=2000, extent=4.0)
    pts[0] = [300.0, 0.0, 0.0]
    vs = _check_fused(pts, mask, 0.1, 1.0, 512)
    assert bool(vs.overflow)


def _check_fused_exact(pts, mask, leaf, face, V, wide_extent):
    """Every output equal bit for bit, statistics included."""
    jo = jax.jit(lambda p, m: jvox.downsample_and_voxelize(
        p, m, leaf, face, V, wide_extent=wide_extent))(pts, mask)
    to = tvox.downsample_and_voxelize(_t(pts), _t(mask), leaf, face, V,
                                      wide_extent=wide_extent)
    jd, jdm, jvs, jpv, jvst = jo
    td, tdm, tvs, tpv, tvst = to
    for a, b in ((jd, td), (jdm, tdm), (jpv, tpv), (jvst, tvst)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f, a, b in zip(jvs._fields, jvs, tvs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    return jvs


def test_wide_extent_matches_jax_on_single_key_cloud():
    """The inputs of tests/test_voxelize.py's two-key test: a cloud that
    fits both layouts."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-9, 9, (3000, 3)).astype(np.float32)
    mask = np.ones(3000, bool)
    mask[2800:] = False
    vs = _check_fused_exact(pts, mask, 0.25, 1.0, 1024, wide_extent=True)
    assert int(np.asarray(vs.valid).sum()) > 500


def test_wide_extent_matches_jax_beyond_single_key_budget():
    """600 face cells along x: the single-key layout clips and flags, the
    two-key layout stays clean, and both match the reference."""
    rng = np.random.default_rng(12)
    pts = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    pts[:, 0] *= 600.0
    mask = np.ones(2000, bool)
    narrow = _check_fused_exact(pts, mask, 0.25, 1.0, 2048, wide_extent=False)
    wide = _check_fused_exact(pts, mask, 0.25, 1.0, 2048, wide_extent=True)
    assert bool(narrow.overflow) and not bool(wide.overflow)


def test_wide_extent_voxel_overflow_matches_jax():
    pts, mask = _scene(2, n=4000, extent=20.0)
    vs = _check_fused_exact(pts, mask, 0.25, 1.0, 256, wide_extent=True)
    assert bool(vs.overflow)


@pytest.mark.parametrize("res,V", [(1.0, 2048), (0.5, 512)])
def test_voxel_stats_matches_jax(res, V):
    """The non-fused face path's voxelization, bit for bit (V=512 at
    0.5 m overflows)."""
    rng = np.random.default_rng(int(res * 10))
    pts = rng.uniform(-6, 6, (5000, 3)).astype(np.float32)
    mask = rng.uniform(size=5000) > 0.1
    (jvs, jpts, jseg) = jax.jit(
        lambda p, m: jvox.voxel_stats(p, m, res, V))(pts, mask)
    tvs, tpts, tseg = tvox.voxel_stats(_t(pts), _t(mask), res, V)
    np.testing.assert_array_equal(tpts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    for f, a, b in zip(jvs._fields, jvs, tvs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    assert bool(tvs.overflow) == (V == 512)


@pytest.mark.parametrize("res", [0.1, 0.5])
def test_voxel_grid_downsample(res):
    pts, mask = _scene(4, n=5000, cap=6000, extent=6.0)
    jd, jm, jo = jax.jit(
        lambda p, m: jvox.voxel_grid_downsample(p, m, res)
    )(pts, mask)
    td, tm, to = tvox.voxel_grid_downsample(_t(pts), _t(mask), res)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(to) == bool(jo)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


def test_pack_cells_roundtrip_and_keys():
    rng = np.random.default_rng(5)
    cells = rng.integers(-50, 50, (400, 3)).astype(np.int32)
    mask = rng.uniform(size=400) > 0.2
    jk, jmin, jovf = jvox._pack_cells(jnp.asarray(cells), jnp.asarray(mask))
    tk, tmin, tovf = tvox._pack_cells(_t(cells), _t(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    assert bool(tovf) == bool(jovf)
    back = tvox._unpack_cells(tk[_t(mask)], tmin).numpy()
    np.testing.assert_array_equal(back, cells[mask])


@pytest.mark.parametrize("capacity", [50, 300, 1000])
def test_compact(capacity):
    rng = np.random.default_rng(capacity)
    valid = rng.uniform(size=(20, 25)) > 0.6
    a = rng.normal(size=(20, 25, 3)).astype(np.float32)
    b = rng.integers(0, 100, (20, 25)).astype(np.int32)
    jo = jvox.compact(jnp.asarray(valid), capacity, jnp.asarray(a), jnp.asarray(b))
    to = tvox.compact(_t(valid), capacity, _t(a), _t(b))
    for x, y in zip(jo, to):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_prefix_sum_matches_reference_association():
    rng = np.random.default_rng(7)
    for shape in [(1,), (16,), (17,), (4097, 9), (20000, 4)]:
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(x))
        np.testing.assert_array_equal(tvox.prefix_sum(_t(x)).numpy(), want)


def test_kth_true_positions():
    rng = np.random.default_rng(8)
    flag = rng.uniform(size=3000) > 0.7
    want = np.flatnonzero(flag)
    for S in (10, len(want), len(want) + 5):
        pos, count = tvox._kth_true_positions(_t(flag), S)
        assert int(count) == len(want)
        k = min(S, len(want))
        np.testing.assert_array_equal(pos.numpy()[:k], want[:k])


def test_pre_downsample(small_pair, params, caps):
    src_p, src_m, _, _, _ = small_pair
    small = dataclasses.replace(caps, max_points=2048)
    tcaps = interop.caps_from_reference(dataclasses.asdict(small))
    tparams = interop.params_from_reference(dataclasses.asdict(params))
    jp, jm, jo = jax.jit(lambda p, m: jpre(p, m, params, small))(src_p, src_m)
    tp, tm, to = tpre(src_p, src_m, tparams, tcaps)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(to) == bool(jo)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
