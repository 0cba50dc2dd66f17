"""Port face extraction (faces_from_voxels) against the JAX stage, fed the
JAX package's own voxelization outputs through ``interop``.

Exact: face labels, planar gate, top-F order, validity, voxel counts,
point sizes and the residual mask. Face centroids/normals: atol 1e-5
(one-hot matmul sums in another order); theta: atol 1e-3 deg (arccos of
a cosine within an ulp of 1 amplifies that ulp to ~1e-4 deg)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fccf_pcr_tpu.features import faces as jfaces
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.ops import voxelize as jvox
from fccf_pcr_torch import interop
from fccf_pcr_torch.features import faces as tfaces
from fccf_pcr_torch.ops import voxelize as tvox


def jax_voxels_and_faces(pts, mask, params, caps):
    """The JAX package's fused voxelization + faces (with labels)."""
    def run(p, m):
        d, dm, vs, pv, vstart = jvox.downsample_and_voxelize(
            p, m, params.leaf_size, params.face_voxel_size, caps.max_voxels
        )
        out = jfaces.faces_from_voxels(
            vs, d, pv, params, caps, with_labels=True, voxel_start=vstart
        )
        return (d, vs, pv, vstart), out

    return jax.jit(run)(pts, mask)


def port_faces(vox, params, caps, with_labels=True):
    d, vs, pv, vstart = vox
    return tfaces.faces_from_voxels(
        interop.from_numpy(tvox.VoxelStats, vs),
        torch.from_numpy(np.array(d)), torch.from_numpy(np.array(pv)),
        interop.params_from_reference(params.__dict__),
        interop.caps_from_reference(caps.__dict__),
        torch.from_numpy(np.array(vstart)), with_labels=with_labels,
    )


def assert_faces_match(j, t):
    for f in ("valid", "voxel_count", "point_size"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    for f in ("centroid", "normal"):
        np.testing.assert_allclose(
            getattr(t, f).numpy(), np.asarray(getattr(j, f)), atol=1e-5
        )
    np.testing.assert_allclose(t.theta.numpy(), np.asarray(j.theta), atol=1e-3)


@pytest.fixture(scope="module")
def clouds(caps):
    out = []
    for seed in (3, 7):
        src, tar, _ = synthetic.make_pair(
            seed=seed, points_per_plane=1500, clutter_points=900
        )
        for cloud in (tar, src):
            out.append(synthetic.pad_points(cloud, caps.max_points))
    return out


@pytest.mark.parametrize("k", range(4))
def test_faces_match_jax(clouds, params, caps, k):
    pts, mask = clouds[k]
    vox, (jf, (_, jres), jovf, jlab) = jax_voxels_and_faces(pts, mask, params, caps)
    tf, (_, tres), tovf, tlab = port_faces(vox, params, caps)
    assert_faces_match(jf, tf)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    assert bool(tovf) == bool(jovf)
    for a, b in zip(jlab, tlab):  # final_label, vvalid, order, fvalid
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(tf.valid.sum()) >= 6


def test_faces_without_labels_are_the_same(clouds, params, caps):
    vox, (jf, _, _, _) = jax_voxels_and_faces(*clouds[0], params, caps)
    tf, _, _ = port_faces(vox, params, caps, with_labels=False)
    assert_faces_match(jf, tf)


@pytest.mark.parametrize("seed", [0, 1])
def test_face_stats_match_jax(seed):
    rng = np.random.default_rng(seed)
    V = 300
    labels = rng.integers(0, 40, V).astype(np.int32)
    valid = rng.uniform(size=V) > 0.2
    count = rng.integers(1, 50, V).astype(np.int32)
    centroid = rng.normal(size=(V, 3)).astype(np.float32)
    normal = rng.normal(size=(V, 3)).astype(np.float32)
    j = jfaces._face_stats(*(jnp.asarray(a) for a in
                             (labels, valid, count, centroid, normal)), V)
    t = tfaces._face_stats(*(torch.from_numpy(a) for a in
                             (labels, valid, count, centroid, normal)), V)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
