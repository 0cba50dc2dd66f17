"""The batched program: every stage of the port with a leading pair axis
against ``jax.vmap`` of its JAX counterpart, and every row of a batch
against its pair run alone at P = 1, on P = 3 pairs of different content
at TEST_CAPS.

The pairs (``PAIRS``): a clean room, whose types 1 and 2 get no
hypotheses (the identity branch of the cluster stage); a noisier room
with 3 type-1 hypotheses (pass-through) and types 0 and 2 clustered; and
noisy stairs, whose types 0 and 1 pass through and whose residual cloud
overflows (status 16). Each stage is fed the JAX package's outputs of the
stage before it (through ``interop``), stacked over the pairs; the clouds
of both sides are one stack of 2P clouds, as ``register.py`` runs them.

Tolerances are those of the per-pair test of the same stage (stated at
each check): integers, masks, labels and status exact everywhere. Rows
against single runs: bit for bit (``torch.equal``) on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fccf_pcr_tpu import make_register_fn as jmake
from fccf_pcr_tpu.cluster import cluster as jcl
from fccf_pcr_tpu.config import TEST_CAPS
from fccf_pcr_tpu.features import faces as jfaces
from fccf_pcr_tpu.fuse import fuse as jfuse
from fccf_pcr_tpu.hypotheses import bases as jbases
from fccf_pcr_tpu.hypotheses import transforms as jtr
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.ops import eigen3 as jeig
from fccf_pcr_tpu.ops import geometry as jgeo
from fccf_pcr_tpu.ops import voxelize as jvox
from fccf_pcr_tpu.pipeline.register import pre_downsample as jpre
from fccf_pcr_tpu.verify import fine as jfine
from fccf_pcr_tpu.verify import quick as jquick
from fccf_pcr_torch import interop
from fccf_pcr_torch import make_register_fn as tmake
from fccf_pcr_torch import pre_downsample as tpre
from fccf_pcr_torch import register_pair as tregister
from fccf_pcr_torch.cluster import cluster as tcl
from fccf_pcr_torch.features import faces as tfaces
from fccf_pcr_torch.fuse import fuse as tfuse
from fccf_pcr_torch.hypotheses import bases as tbases
from fccf_pcr_torch.hypotheses import transforms as ttr
from fccf_pcr_torch.ops import eigen3 as teig
from fccf_pcr_torch.ops import geometry as tgeo
from fccf_pcr_torch.ops import label_prop as tlp
from fccf_pcr_torch.ops import voxelize as tvox
from fccf_pcr_torch.pipeline import sweep as tsweep
from fccf_pcr_torch.refine import gauss_newton as tgn
from fccf_pcr_torch.verify import fine as tfine
from fccf_pcr_torch.verify import quick as tquick

from test_torch_cluster import _pool
from test_torch_pipeline import assert_result_matches

PAIRS = (
    dict(seed=0),
    dict(seed=2, noise=0.02),
    dict(seed=1, scene="stairs", noise=0.04),
)
P = len(PAIRS)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(params, caps):
    return (interop.params_from_reference(dataclasses.asdict(params)),
            interop.caps_from_reference(dataclasses.asdict(caps)))


def _row(x, k):
    """Row k of every tensor in x (nested tuples), keeping a pair axis of
    1; anything else passes through."""
    if isinstance(x, torch.Tensor):
        return x[k:k + 1]
    if isinstance(x, tuple):
        rows = [_row(v, k) for v in x]
        return type(x)(*rows) if hasattr(x, "_fields") else tuple(rows)
    return x


def _assert_bitwise(a, b, what="out"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), f"{what} differs from the single run"
        return
    for i, (x, y) in enumerate(zip(a, b)):
        _assert_bitwise(x, y, f"{what}[{i}]")


def rows_alone(fn, *args, n=P):
    """fn on the whole batch, and each row of its output equal, bit for
    bit, to fn on that row alone (a pair axis of 1)."""
    full = fn(*args)
    for k in range(n):
        _assert_bitwise(_row(full, k), fn(*(_row(a, k) for a in args)),
                        f"row {k}")
    return full


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _equal(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def clouds(caps):
    """(sp, sm, tp, tm): the P pairs padded to caps.max_points, stacked."""
    out = [[], [], [], []]
    for kw in PAIRS:
        src, tar, _ = synthetic.make_pair(points_per_plane=1500,
                                          clutter_points=900, **kw)
        for k, a in enumerate(synthetic.pad_points(src, caps.max_points)
                              + synthetic.pad_points(tar, caps.max_points)):
            out[k].append(a)
    return [np.stack(a) for a in out]


@pytest.fixture(scope="module")
def jax_stages(clouds, params, caps):
    """The JAX package's stages, vmapped over the pairs (the 2P clouds,
    targets first, for the voxelization and the faces)."""
    sp, sm, tp, tm = clouds
    pts, msk = np.concatenate([tp, sp]), np.concatenate([tm, sm])

    def vox(p, m):
        return jvox.downsample_and_voxelize(
            p, m, params.leaf_size, params.face_voxel_size, caps.max_voxels)

    d, dm, vs, pv, vstart = jax.jit(jax.vmap(vox))(pts, msk)
    faces, (res_pts, res_mask), ovf, labels = jax.jit(jax.vmap(
        lambda vs, d, pv, st: jfaces.faces_from_voxels(
            vs, d, pv, params, caps, with_labels=True, voxel_start=st)
    ))(vs, d, pv, vstart)
    f1 = jax.tree.map(lambda x: x[:P], faces)
    f2 = jax.tree.map(lambda x: x[P:], faces)
    bases = jax.jit(jax.vmap(lambda f: jbases.select_bases(f, params)))(faces)
    b1 = jax.tree.map(lambda x: x[:P], bases)
    b2 = jax.tree.map(lambda x: x[P:], bases)
    hyp = jax.jit(jax.vmap(lambda a, b, c, e: jtr.generate_hypotheses(
        a, b, c, e, params, caps)))(f1, f2, b1, b2)
    reps = jax.jit(jax.vmap(lambda h: jcl.cluster_hypotheses(
        h, params, caps)))(hyp)
    return dict(pts=pts, msk=msk, vox=(d, dm, vs, pv, vstart), faces=faces,
                residual=(res_pts, res_mask), ovf=ovf, labels=labels,
                f1=f1, f2=f2, bases=bases, hyp=hyp, reps=reps)


# --------------------------------------------------------------- voxelize --


@pytest.mark.parametrize("wide_extent", [False, True],
                         ids=["one_key", "two_key"])
def test_downsample_and_voxelize_batch(jax_stages, params, caps, wide_extent):
    """Both key layouts on the 2P clouds: masks, point_voxel, voxel_start,
    counts and flags exact; points and statistics atol 1e-5 (one key) and
    bit for bit (two keys), the tolerances of test_torch_voxelize.py."""
    pts, msk = jax_stages["pts"], jax_stages["msk"]

    def run(p, m):
        return tvox.downsample_and_voxelize(
            p, m, params.leaf_size, params.face_voxel_size, caps.max_voxels,
            wide_extent=wide_extent)

    td, tdm, tvs, tpv, tvst = rows_alone(run, _t(pts), _t(msk), n=2 * P)
    jd, jdm, jvs, jpv, jvst = jax.jit(jax.vmap(lambda p, m: (
        jvox.downsample_and_voxelize(p, m, params.leaf_size,
                                     params.face_voxel_size, caps.max_voxels,
                                     wide_extent=wide_extent))))(pts, msk)
    for t, j in ((tdm, jdm), (tpv, jpv), (tvst, jvst), (tvs.count, jvs.count),
                 (tvs.valid, jvs.valid), (tvs.overflow, jvs.overflow)):
        _equal(t, j)
    atol = 0.0 if wide_extent else 1e-5
    for t, j in ((td, jd), (tvs.centroid, jvs.centroid), (tvs.cov, jvs.cov)):
        _close(t, j, rtol=0, atol=atol)
    assert tvs.valid.sum(-1).min() > 50


def test_downsample_voxel_stats_compact_and_pre_batch(clouds, params, caps):
    """voxel_grid_downsample, pre_downsample and compact (atol 1e-5 on
    points, masks and flags exact) and voxel_stats (bit for bit) over the
    2P raw clouds, against their vmaps."""
    sp, sm, tp, tm = clouds
    pts, msk = np.concatenate([tp, sp]), np.concatenate([tm, sm])
    n = 2 * P

    td, tm_, to = rows_alone(
        lambda p, m: tvox.voxel_grid_downsample(p, m, params.leaf_size),
        _t(pts), _t(msk), n=n)
    jd, jm, jo = jax.jit(jax.vmap(
        lambda p, m: jvox.voxel_grid_downsample(p, m, params.leaf_size)))(
            pts, msk)
    _equal(tm_, jm)
    _equal(to, jo)
    _close(td, jd, atol=1e-5)

    small = dataclasses.replace(caps, max_points=2048)
    tparams, tcaps = _port(params, small)
    tp_, tm2, to2 = rows_alone(
        lambda p, m: tpre(p, m, tparams, tcaps, device=None),
        _t(pts), _t(msk), n=n)
    jp, jm2, jo2 = jax.jit(jax.vmap(lambda p, m: jpre(p, m, params, small)))(
        pts, msk)
    _equal(tm2, jm2)
    _equal(to2, jo2)
    assert bool(to2.any())  # 2048 slots overflow on some clouds
    _close(tp_, jp, atol=1e-5)

    tc = rows_alone(lambda v, a: tvox.compact(v, 700, a, batch_dims=1),
                    tm_, td, n=n)
    jc = jax.vmap(lambda v, a: jvox.compact(v, 700, a))(jm, jd)
    for t, j in zip(tc[:3], jc[:3]):
        _equal(t, j)
    _close(tc[3], jc[3], atol=1e-5)

    (tvs, tpts, tseg) = rows_alone(
        lambda p, m: tvox.voxel_stats(p, m, params.face_voxel_size, 512),
        _t(pts), _t(msk), n=n)
    (jvs, jpts, jseg) = jax.jit(jax.vmap(
        lambda p, m: jvox.voxel_stats(p, m, params.face_voxel_size, 512)))(
            pts, msk)
    _equal(tpts, jpts)
    _equal(tseg, jseg)
    for f, a, b in zip(jvs._fields, jvs, tvs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


def test_scans_per_row():
    """prefix_sum along a row axis is XLA's per-row cumsum bit for bit,
    and _kth_true_positions finds each row's True positions."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (3, 4097, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda v: jnp.cumsum(v, axis=0)))(x))
    _equal(rows_alone(lambda v: tvox.prefix_sum(v, dim=1), _t(x)), want)
    flag = rng.uniform(size=(3, 3000)) > np.array([[0.2], [0.7], [0.99]])
    pos, count = rows_alone(lambda f: tvox._kth_true_positions(f, 100),
                            _t(flag))
    for k in range(3):
        want = np.flatnonzero(flag[k])
        assert int(count[k]) == len(want)
        m = min(100, len(want))
        np.testing.assert_array_equal(pos[k].numpy()[:m], want[:m])


# ------------------------------------------------------ plane fits, faces --


def test_plane_fit_batch(jax_stages):
    """(2P, V, 3, 3) covariances: normals and curvatures bit for bit, as
    in test_torch_ops.py."""
    cov = np.asarray(jax_stages["vox"][2].cov)
    jn, jc = jax.jit(jax.vmap(jeig.plane_fit_from_cov))(cov)
    tn, tc = rows_alone(teig.plane_fit_from_cov, _t(cov), n=2 * P)
    _equal(tn, jn)
    _equal(tc, jc)


def test_faces_batch(jax_stages, params, caps):
    """faces_from_voxels over the 2P clouds' voxels: labels, planar gate,
    top-F order, validity, voxel counts, point sizes and residual masks
    exact; centroids and normals atol 1e-5, theta atol 1e-3 deg (the
    tolerances of test_torch_faces.py)."""
    d, _, vs, pv, vstart = jax_stages["vox"]
    tparams, tcaps = _port(params, caps)

    def run(vs, d, pv, st):
        return tfaces.faces_from_voxels(vs, d, pv, tparams, tcaps,
                                        voxel_start=st, with_labels=True)

    tf, (_, tres), tovf, tlab = rows_alone(
        run, interop.from_numpy(tvox.VoxelStats, vs), _t(d), _t(pv),
        _t(vstart), n=2 * P)
    jf = jax_stages["faces"]
    for f in ("valid", "voxel_count", "point_size"):
        _equal(getattr(tf, f), getattr(jf, f))
    for f in ("centroid", "normal"):
        _close(getattr(tf, f), getattr(jf, f), atol=1e-5)
    _close(tf.theta, jf.theta, atol=1e-3)
    _equal(tres, jax_stages["residual"][1])
    _equal(tovf, jax_stages["ovf"])
    for a, b in zip(jax_stages["labels"], tlab):
        _equal(b, a)
    assert int(tf.valid.sum(-1).min()) >= 6


def test_label_propagate_batch():
    """The plain version over a batch of pairs whose propagations take
    different numbers of sweeps: each row equals its pair alone (the JAX
    package's labels for these pairs are pinned in
    test_torch_label_prop.py)."""
    rng = np.random.default_rng(0)
    V = 300
    normal = rng.normal(size=(3, V, 3)).astype(np.float32)
    normal[:2] = np.array([0, 0, 1], np.float32)
    centroid = rng.uniform(-3, 3, (3, V, 3)).astype(np.float32)
    centroid[0, :, 2] = 0.0
    centroid[1, :, 2] = 10.0 * np.arange(V)  # no pair affine
    valid = rng.uniform(size=(3, V)) < np.array([[0.9], [0.5], [0.8]])
    got = rows_alone(
        lambda n, c, v: tlp.label_propagate(n, c, v, 5.0, 0.5, 5.0),
        _t(normal), _t(centroid), _t(valid))
    assert len(torch.unique(got[0][valid[0]])) == 1
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.where(valid[1], np.arange(V), 2**30))


# --------------------------------------------------- hypotheses, cluster --


def test_bases_and_hypotheses_batch(jax_stages, params, caps):
    """select_bases over the 2P face sets and generate_hypotheses over the
    P pairs: indices, types, validity, counts and flags exact; angles
    atol 1e-3 deg (test_torch_hypotheses.py) between 1 and 179 deg, where
    no base can be valid anyway; nearer 0 or 180 deg the arccos turns one
    float32 ulp of the cosine into up to 3e-3 deg, so there the cosines
    are compared, atol 1.2e-7 (two ulps); quaternions atol 1e-5;
    translations rtol / atol 1e-4 (test_torch_hypotheses.py)."""
    tparams, tcaps = _port(params, caps)
    tfs = interop.from_numpy(tfaces.Faces, jax_stages["faces"])
    tb = rows_alone(lambda f: tbases.select_bases(f, tparams), tfs, n=2 * P)
    jb = jax_stages["bases"]
    for f in ("i", "j", "type_", "valid"):
        _equal(getattr(tb, f), getattr(jb, f))
    ja = np.asarray(jb.angle)
    inner = (ja > 1.0) & (ja < 179.0)
    np.testing.assert_allclose(tb.angle.numpy()[inner], ja[inner], atol=1e-3)
    np.testing.assert_allclose(np.cos(np.deg2rad(tb.angle.numpy()[~inner])),
                               np.cos(np.deg2rad(ja[~inner])), rtol=0,
                               atol=1.2e-7)

    f1, f2 = (interop.from_numpy(tfaces.Faces, jax_stages[k])
              for k in ("f1", "f2"))
    th = rows_alone(lambda a, b: ttr.generate_hypotheses(
        a, b, tparams, tcaps), f1, f2)
    jh = jax_stages["hyp"]
    for f in ("valid", "type_", "count", "overflow"):
        _equal(getattr(th, f), getattr(jh, f))
    _close(th.quat, jh.quat, atol=1e-5)
    _close(th.t, jh.t, rtol=1e-4, atol=1e-4)


def _type_counts(hyp):
    valid, type_ = np.asarray(hyp.valid), np.asarray(hyp.type_)
    return np.stack([(valid & (type_ == ty)).sum(-1) for ty in range(3)], -1)


def _check_cluster_batch(hyp, params, caps):
    """The seed scan (seeds and sizes exact, sums rtol 1e-5 / atol 1e-4)
    and the representatives (validity and overflow exact, quaternions
    and translations atol 1e-4), as test_torch_cluster.py holds them."""
    tparams, tcaps = _port(params, caps)
    thyp = interop.from_numpy(ttr.Hypotheses, hyp)
    H = hyp.valid.shape[-1]
    xh = jnp.broadcast_to(jnp.array([1.0, 0, 0], jnp.float32), (H, 3))
    yh = jnp.broadcast_to(jnp.array([0, 1.0, 0], jnp.float32), (H, 3))

    def jseeds(h):
        masks = h.valid[None] & (h.type_[None] == jnp.arange(3)[:, None])
        return jcl._greedy_seeds_all_types(
            masks, h.t, jgeo.quat_rotate(h.quat, xh),
            jgeo.quat_rotate(h.quat, yh), params)

    def tseeds(h):
        masks = h.valid[:, None] & (h.type_[:, None] == torch.arange(3)[:, None])
        x, y = (tgeo.quat_rotate(h.quat, torch.tensor(a).expand(h.t.shape))
                for a in ([1.0, 0, 0], [0, 1.0, 0]))
        return tcl._greedy_seeds_all_types(masks, h.t, x, y, tparams)

    js = jax.jit(jax.vmap(jseeds))(hyp)
    ts = rows_alone(tseeds, thyp)
    _equal(ts[0], js[0])
    _equal(ts[1], js[1])
    _close(ts[2], js[2], rtol=1e-5, atol=1e-4)

    jr = jax.jit(jax.vmap(lambda h: jcl.cluster_hypotheses(h, params, caps)))(
        hyp)
    tr = rows_alone(lambda h: tcl.cluster_hypotheses(h, tparams, tcaps), thyp)
    _equal(tr.valid, jr.valid)
    _equal(tr.overflow, jr.overflow)
    _close(tr.quat, jr.quat, atol=1e-4)
    _close(tr.t, jr.t, atol=1e-4)
    return jr


def test_cluster_batch_of_pipeline_pools(jax_stages, params, caps):
    """The pairs' own pools: every branch of the count test in one batch
    (a type with 0 hypotheses, one with 1-10, clustered ones)."""
    counts = _type_counts(jax_stages["hyp"])
    assert (counts == 0).any()
    assert ((counts > 0) & (counts <= 10)).any()
    assert (counts > 10).any()
    _check_cluster_batch(jax_stages["hyp"], params, caps)


def test_cluster_batch_of_lanes_with_different_block_counts(params):
    """Synthetic pools of 1, 2 and 1 seed blocks (H = 2048, blocks of
    512): the scan runs to the longest lane and the others keep their
    results; the two lanes with a clustered type overflow max_reps, the
    pass-through lane does not."""
    rng = np.random.default_rng(21)
    pools = [_pool(rng, c, n_centers=n) for c, n in
             (((0, 7, 300), 12), ((400, 250, 120), 60), ((5, 0, 0), 12))]
    hyp = jax.tree.map(lambda *x: jnp.stack(x), *pools)
    caps = dataclasses.replace(TEST_CAPS, max_reps=32)
    jr = _check_cluster_batch(hyp, params, caps)
    assert np.asarray(jr.overflow).tolist() == [True, True, False]


# ------------------------------------------- quick verify, refine, fine --


@pytest.fixture(scope="module")
def rep_transforms(jax_stages):
    reps = jax_stages["reps"]
    return np.asarray(jgeo.make_transform(jgeo.quat_to_matrix(reps.quat),
                                          reps.t))


def test_match_faces_batch(jax_stages, rep_transforms, params):
    """match_faces over (P, 3, C) representatives, each pair against its
    own faces: pair counts exact, scores and the rest rtol 1e-5 / atol
    1e-6 (test_torch_verify.py)."""
    tparams, _ = _port(params, TEST_CAPS)
    T = rep_transforms[:, :, :64]
    j = jax.jit(jax.vmap(lambda T, a, b: jax.vmap(jax.vmap(
        lambda t: jquick.match_faces(t, a, b, params)))(T)))(
            T, jax_stages["f1"], jax_stages["f2"])
    f1, f2 = (interop.from_numpy(tfaces.Faces, jax_stages[k])
              for k in ("f1", "f2"))
    t = rows_alone(lambda T, a, b: tquick.match_faces(T, a, b, tparams),
                   _t(T), f1, f2)
    assert t[0].shape == (P, 3, 64)
    _equal(t[1], j[1])
    for a, b in zip(j[:1] + j[2:], t[:1] + t[2:]):
        _close(b, a, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def top_transforms(jax_stages, rep_transforms, params):
    """(P, 3, K) transforms: each type's top K representatives by the JAX
    package's quick score, the candidates the pipeline refines."""
    q = jax.jit(jax.vmap(lambda T, a, b: jax.vmap(jax.vmap(
        lambda t: jquick.match_faces(t, a, b, params)[0]))(T)))(
            rep_transforms, jax_stages["f1"], jax_stages["f2"])
    q = np.where(np.asarray(jax_stages["reps"].valid), np.asarray(q), -np.inf)
    K = params.fine_verify_number
    idx = np.argsort(-q, axis=-1, kind="stable")[..., :K]
    return np.take_along_axis(rep_transforms, idx[..., None, None], axis=2)


def test_refine_transform_batch(jax_stages, top_transforms, params):
    """refine_transform over the P x 3 x K candidates the pipeline
    refines, one LM call of 36 lanes that stop at different iterations (a
    lane's transform no longer changes with more iterations): atol 1e-4
    (test_torch_verify.py)."""
    tparams, _ = _port(params, TEST_CAPS)
    T = top_transforms
    j = jax.jit(jax.vmap(lambda T, a, b: jax.vmap(jax.vmap(
        lambda t: jquick.refine_transform(t, a, b, params)))(T)))(
            T, jax_stages["f1"], jax_stages["f2"])
    f1, f2 = (interop.from_numpy(tfaces.Faces, jax_stages[k])
              for k in ("f1", "f2"))
    t = rows_alone(lambda T, a, b: tquick.refine_transform(T, a, b, tparams),
                   _t(T), f1, f2)
    assert t.shape == (P, 3, 4, 4, 4)
    _close(t, j, atol=1e-4)

    def at(iters):
        p = dataclasses.replace(tparams, refine_iters=iters)
        return tquick.refine_transform(_t(T), f1, f2, p).reshape(-1, 16)

    final = at(50)
    moved = ~torch.all(torch.stack([at(i) for i in (1, 3, 8)]) == final, -1)
    done_at = moved.sum(0)  # caps 1, 3, 8 below which a lane still moves
    assert len(torch.unique(done_at)) >= 2


def test_fine_verify_batch(jax_stages, top_transforms, params, caps):
    """build_source_table over the P target residuals (bit for bit) and
    fine_verify of P x 12 candidates, each against its own pair's table
    and source residual: scores rtol 1e-3, alias flags exact
    (test_torch_verify.py)."""
    tparams, tcaps = _port(params, caps)
    res_pts, res_mask = jax_stages["residual"]
    _, _, rv, rp = jax.vmap(lambda m, p: jvox.compact(m, caps.max_residual,
                                                      p))(res_mask, res_pts)
    jt = jax.jit(jax.vmap(lambda p, m: jfine.build_source_table(
        p, m, params, caps)))(rp[:P], rv[:P])
    tt = rows_alone(lambda p, m: tfine.build_source_table(p, m, tparams, tcaps),
                    _t(rp[:P]), _t(rv[:P]))
    for f in jt._fields:
        np.testing.assert_array_equal(
            getattr(tt, f).numpy(),
            np.asarray(getattr(jt, f)).astype(getattr(tt, f).numpy().dtype))
    T = top_transforms.reshape(P, 12, 4, 4)
    j = jax.jit(jax.vmap(lambda T, tab, p, m: jax.vmap(
        lambda t: jfine.fine_verify(t, tab, p, m, params, caps))(T)))(
            T, jt, rp[P:], rv[P:])
    t = rows_alone(lambda T, tab, p, m: tfine.fine_verify(T, tab, p, m,
                                                          tparams, tcaps),
                   _t(T), tt, _t(rp[P:]), _t(rv[P:]))
    _close(t[0], j[0], rtol=1e-3)
    _equal(t[1], j[1])
    assert (np.asarray(j[0]) > 0.05).any()


def test_fuse_batch():
    """fuse_transforms over P sets of per-type winners, one with nothing
    kept (identity): rtol 1e-5 / atol 1e-6 (test_torch_ops.py)."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(4, 3, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(4, 3, 3)).astype(np.float32)
    score = rng.uniform(0.2, 1.0, (4, 3)).astype(np.float32)
    valid = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 0], [0, 1, 0]], bool)
    j = jax.jit(jax.vmap(jfuse.fuse_transforms))(q, t, score, valid)
    got = rows_alone(tfuse.fuse_transforms, _t(q), _t(t), _t(score),
                     _t(valid), n=4)
    _close(got, j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.eye(4))


# ------------------------------------------------------------- pipeline --


def test_register_batch_matches_vmap_and_rows_alone(clouds, params, caps):
    """make_register_fn(batched=True) at P = 3 against the JAX package's
    jit(vmap(register_pair)) (the golden bands of test_golden.py, as
    assert_result_matches holds them), and each row equal, bit for bit,
    to register_pair on that pair alone."""
    j = jmake(params, caps, batched=True)(*clouds)
    tparams, tcaps = _port(params, caps)
    t = tmake(tparams, tcaps, batched=True, device="cpu")(*clouds)
    assert t.transform.shape == (P, 4, 4)
    for k in range(P):
        assert_result_matches(type(t)(*(f[k] for f in t)),
                              type(j)(*(f[k] for f in j)))
        alone = tregister(*(c[k] for c in clouds), tparams, tcaps,
                          device="cpu")
        _assert_bitwise(type(t)(*(f[k] for f in t)), alone, f"pair {k}")
    assert t.status.tolist() == [0, 0, 16]


def test_sweep_batch_3_gives_the_records_of_batch_1(params, caps):
    """run_sweep over 4 pairs at batch 3 (the last chunk padded with two
    repeats) writes the records of batch 1, timing aside."""
    tparams, tcaps = _port(params, caps)
    pairs = []
    for seed in range(4):
        src, tar, _ = synthetic.make_pair(seed=seed, points_per_plane=400,
                                          clutter_points=200)
        pairs.append((src, tar))

    def records(batch):
        recs, _ = tsweep.run_sweep(pairs, tparams, tcaps, batch_size=batch,
                                   device="cpu")
        return [{k: v for k, v in r.items() if k != "batch_time_s"}
                for r in recs]

    three = records(3)
    assert [r["pair"] for r in three] == [0, 1, 2, 3]
    assert three == records(1)


def test_refine_pairs_batch_is_one_call(jax_stages, top_transforms, params):
    """The P x 3 x K candidates are one refine_pairs call (one host sync
    an LM iteration for the batch), whatever P is."""
    tparams, _ = _port(params, TEST_CAPS)
    T = _t(top_transforms)
    f1, f2 = (interop.from_numpy(tfaces.Faces, jax_stages[k])
              for k in ("f1", "f2"))
    calls = []
    refine = tquick.refine_pairs

    def record(**kw):
        calls.append(kw["n1"].shape[0])
        return refine(**kw)

    tquick.refine_pairs = record
    try:
        tquick.refine_transform(T, f1, f2, tparams)
    finally:
        tquick.refine_pairs = refine
    assert calls == [P * 3 * 4]
    assert tquick.refine_pairs is tgn.refine_pairs
