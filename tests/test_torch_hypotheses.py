"""Port bases + hypothesis generation against the JAX stage on identical
faces (random faces, and the JAX package's faces of a synthetic pair).

Exact: base pairs, types and validity; hypothesis validity, types,
count, emission order and overflow flags. Quaternions: atol 1e-5;
translations: atol 1e-4 + rtol 1e-4 (a 3x3 normal-equation inverse can
amplify float32 rounding by its condition number)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fccf_pcr_tpu.config import TEST_CAPS, FCCFParams
from fccf_pcr_tpu.features import faces as jfaces
from fccf_pcr_tpu.hypotheses import bases as jbases
from fccf_pcr_tpu.hypotheses import transforms as jtr
from fccf_pcr_tpu.ops import voxelize as jvox
from fccf_pcr_torch import interop
from fccf_pcr_torch.features.faces import Faces as TFaces
from fccf_pcr_torch.hypotheses import bases as tbases
from fccf_pcr_torch.hypotheses import transforms as ttr


def _random_faces(rng, n, F=16):
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals *= rng.uniform(0.97, 1.0, (n, 1))
    pad = F - n
    return jfaces.Faces(
        centroid=jnp.asarray(np.concatenate(
            [rng.uniform(-8, 8, (n, 3)), np.zeros((pad, 3))]), jnp.float32),
        normal=jnp.asarray(np.concatenate([normals, np.zeros((pad, 3))]),
                           jnp.float32),
        point_size=jnp.asarray(np.concatenate(
            [rng.uniform(50, 4000, n), np.zeros(pad)]), jnp.float32),
        voxel_count=jnp.asarray(np.concatenate(
            [np.ones(n), np.zeros(pad)]), jnp.int32),
        theta=jnp.asarray(np.concatenate(
            [rng.uniform(0.2, 4.0, n), np.zeros(pad)]), jnp.float32),
        valid=jnp.asarray(np.arange(F) < n),
    )


def _rotated_copy(rng, faces, angle_deg=25.0):
    """The same faces seen from a rotated, translated frame (so bases
    match and hypotheses form)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    th = np.deg2rad(angle_deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(size=3)
    n = np.asarray(faces.normal) @ R.T
    c = np.asarray(faces.centroid) @ R.T + t
    v = np.asarray(faces.valid)[:, None]
    return faces._replace(
        normal=jnp.asarray(np.where(v, n, 0.0), jnp.float32),
        centroid=jnp.asarray(np.where(v, c, 0.0), jnp.float32),
    )


def jax_pair_faces(pair, params, caps):
    def faces_of(p, m):
        d, _, vs, pv, vstart = jvox.downsample_and_voxelize(
            p, m, params.leaf_size, params.face_voxel_size, caps.max_voxels
        )
        return jfaces.faces_from_voxels(vs, d, pv, params, caps,
                                        voxel_start=vstart)[0]

    src_p, src_m, tar_p, tar_m, _ = pair
    fn = jax.jit(faces_of)
    return fn(tar_p, tar_m), fn(src_p, src_m)


def to_port(faces):
    return interop.from_numpy(TFaces, faces)


def check_hypotheses(f1, f2, params, caps):
    tparams = interop.params_from_reference(dataclasses.asdict(params))
    tcaps = interop.caps_from_reference(dataclasses.asdict(caps))
    jb1, jb2 = jbases.select_bases(f1, params), jbases.select_bases(f2, params)
    tf1, tf2 = to_port(f1), to_port(f2)
    tb1, tb2 = tbases.select_bases(tf1, tparams), tbases.select_bases(tf2, tparams)
    for jb, tb in ((jb1, tb1), (jb2, tb2)):
        for f in ("i", "j", "type_", "valid"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))
        np.testing.assert_allclose(tb.angle.numpy(), np.asarray(jb.angle),
                                   atol=1e-3)
    jh = jax.jit(lambda a, b, c, d: jtr.generate_hypotheses(
        a, b, c, d, params, caps))(f1, f2, jb1, jb2)
    th = ttr.generate_hypotheses(tf1, tf2, tparams, tcaps)
    for f in ("valid", "type_", "count", "overflow"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)))
    np.testing.assert_allclose(th.quat.numpy(), np.asarray(jh.quat), atol=1e-5)
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t),
                               rtol=1e-4, atol=1e-4)
    return jh, th


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_faces(seed):
    rng = np.random.default_rng(seed)
    f1 = _random_faces(rng, 12)
    f2 = _rotated_copy(rng, f1)
    jh, _ = check_hypotheses(f1, f2, FCCFParams(), TEST_CAPS)
    assert int(jh.count) > 0


def test_pipeline_faces(small_pair, params, caps):
    f1, f2 = jax_pair_faces(small_pair, params, caps)
    jh, _ = check_hypotheses(f1, f2, params, caps)
    assert int(jh.count) > 100


@pytest.mark.parametrize(
    "over", [dict(max_matches=64), dict(max_hypotheses=512),
             dict(per_match_hits=2)],
)
def test_overflow_flags(over):
    rng = np.random.default_rng(9)
    f1 = _random_faces(rng, 14)
    f2 = _rotated_copy(rng, f1)
    jh, _ = check_hypotheses(f1, f2, FCCFParams(),
                             dataclasses.replace(TEST_CAPS, **over))
    assert bool(jh.overflow)
