"""Port quick verify, LM refinement and fine verify against the JAX stages
on identical inputs (the JAX package's faces, representatives and
residual clouds of a synthetic pair, plus targeted cases).

Exact: matched-pair counts, table keys/counts and the overflow/alias
flags. Quick scores: rtol 1e-5 / atol 1e-6. Refined transforms: atol
1e-4 (50 LM iterations of float32 6x6 solves). Fine scores: rtol 1e-3
(a point on a 0.5 m cell boundary may land in the next cell under a
transform that differs in the last bit)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fccf_pcr_tpu.cluster import cluster as jcl
from fccf_pcr_tpu.config import TEST_CAPS, FCCFParams
from fccf_pcr_tpu.hypotheses import bases as jbases
from fccf_pcr_tpu.hypotheses import transforms as jtr
from fccf_pcr_tpu.ops import geometry as jgeo
from fccf_pcr_tpu.ops import voxelize as jvox
from fccf_pcr_tpu.refine import gauss_newton as jgn
from fccf_pcr_tpu.verify import fine as jfine
from fccf_pcr_tpu.verify import quick as jquick
from fccf_pcr_torch import interop
from fccf_pcr_torch.features.faces import Faces as TFaces
from fccf_pcr_torch.refine import gauss_newton as tgn
from fccf_pcr_torch.verify import fine as tfine
from fccf_pcr_torch.verify import quick as tquick

from test_torch_hypotheses import jax_pair_faces


@pytest.fixture(scope="module")
def stage_inputs(small_pair, params, caps):
    """JAX faces of both clouds and the representative transforms."""
    f1, f2 = jax_pair_faces(small_pair, params, caps)
    reps = jax.jit(lambda a, b: jcl.cluster_hypotheses(
        jtr.generate_hypotheses(a, b, jbases.select_bases(a, params),
                                jbases.select_bases(b, params), params, caps),
        params, caps))(f1, f2)
    rep_T = np.asarray(jgeo.make_transform(jgeo.quat_to_matrix(reps.quat),
                                           reps.t))
    valid = np.asarray(reps.valid)
    return f1, f2, rep_T[valid][:64]


def _tparams(params):
    return interop.params_from_reference(dataclasses.asdict(params))


def test_match_faces(stage_inputs, params):
    f1, f2, T = stage_inputs
    j = jax.jit(jax.vmap(lambda t: jquick.match_faces(t, f1, f2, params)))(T)
    t = tquick.match_faces(torch.from_numpy(T), interop.from_numpy(TFaces, f1),
                           interop.from_numpy(TFaces, f2), _tparams(params))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    for a, b in zip(j[:1] + j[2:], t[:1] + t[2:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    assert (np.asarray(j[0]) > 0).any()


def test_refine_transform(stage_inputs, params):
    f1, f2, T = stage_inputs
    T = T[:12]
    j = jax.jit(jax.vmap(lambda t: jquick.refine_transform(t, f1, f2, params)))(T)
    t = tquick.refine_transform(
        torch.from_numpy(T).reshape(3, 4, 4, 4),
        interop.from_numpy(TFaces, f1), interop.from_numpy(TFaces, f2),
        _tparams(params),
    )
    assert t.shape == (3, 4, 4, 4)
    np.testing.assert_allclose(t.reshape(12, 4, 4).numpy(), np.asarray(j),
                               atol=1e-4)


@pytest.mark.parametrize("iters", [1, 3, 50])
def test_refine_pairs_lanes_freeze_like_vmap(iters):
    """Lanes that finish early keep their state while others iterate, and
    an all-zero-weight lane returns the identity."""
    rng = np.random.default_rng(iters)
    B, P = 6, 16
    n1 = rng.normal(size=(B, P, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    p1 = rng.uniform(-5, 5, (B, P, 3)).astype(np.float32)
    # each lane: the pairs under a different small perturbation
    ang = rng.normal(0, 0.05 * np.arange(1, B + 1)[:, None], (B, 3))
    q = np.concatenate([np.ones((B, 1)), ang / 2], axis=1).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(q)))
    n2 = np.einsum("bij,bpj->bpi", R, n1).astype(np.float32)
    p2 = (np.einsum("bij,bpj->bpi", R, p1) + 0.1).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (B, P)).astype(np.float32)
    w[:, -3:] = 0.0
    w[0] = 0.0  # an inert lane: the port stops without it, JAX runs it out
    j = jax.jit(jax.vmap(lambda *a: jgn.refine_pairs(*a, iters=iters)))(
        n1, p1, n2, p2, w)
    t = tgn.refine_pairs(*(torch.from_numpy(a) for a in (n1, p1, n2, p2, w)),
                         iters=iters)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)
    np.testing.assert_array_equal(t[0].numpy(), np.eye(4))


def _residual_cloud(seed, n, cap, extent):
    rng = np.random.default_rng(seed)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.uniform(-extent, extent, (n, 3))
    return pts, np.arange(cap) < n


def _check_table(pts, mask, params, caps):
    tparams = _tparams(params)
    tcaps = interop.caps_from_reference(dataclasses.asdict(caps))
    jt = jax.jit(lambda p, m: jfine.build_source_table(p, m, params, caps))(pts, mask)
    tt = tfine.build_source_table(torch.from_numpy(pts), torch.from_numpy(mask),
                                  tparams, tcaps)
    for f in jt._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)).astype(
                                          getattr(tt, f).numpy().dtype))
    return jt, tt


def test_fine_verify_scores(small_pair, params, caps, stage_inputs):
    _, _, T = stage_inputs
    src_p, src_m, tar_p, tar_m, _ = small_pair
    vox = jax.jit(lambda p, m: jvox.voxel_grid_downsample(p, m, 0.25))
    tp, tm, _ = vox(tar_p, tar_m)
    sp, sm, _ = vox(src_p, src_m)
    tmask, tpts = (np.array(a) for a in jvox.compact(tm, 2048, tp)[2:])
    smask, spts = (np.array(a) for a in jvox.compact(sm, 2048, sp)[2:])
    jt, tt = _check_table(tpts, tmask, params, caps)
    Tc = T[:12]
    j = jax.jit(jax.vmap(lambda t: jfine.fine_verify(t, jt, spts, smask,
                                                     params, caps)))(Tc)
    t = tfine.fine_verify(torch.from_numpy(Tc), tt, torch.from_numpy(spts),
                          torch.from_numpy(smask), _tparams(params),
                          interop.caps_from_reference(dataclasses.asdict(caps)))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-3)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert (np.asarray(j[0]) > 0.05).any()


def test_table_overflow_and_alias():
    params = FCCFParams()
    pts, mask = _residual_cloud(1, 1500, 2048, 40.0)
    jt, _ = _check_table(pts, mask, params,
                         dataclasses.replace(TEST_CAPS, max_fine_voxels=256))
    assert bool(jt.overflow)
    pts[0] = [700.0, 0.0, 0.0]  # span > 1024 cells of 0.5 m
    jt, _ = _check_table(pts, mask, params, TEST_CAPS)
    assert bool(jt.aliased)
