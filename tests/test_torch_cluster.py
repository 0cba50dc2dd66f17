"""Port hypothesis clustering against the JAX stage on identical
hypothesis pools (synthetic pools exercising every branch, and the
JAX package's pool of a synthetic pair).

Exact: greedy seeds, cluster sizes, representative validity/emission
order and the overflow flag. Cluster member sums: rtol 1e-5 / atol 1e-4
(matmul sums in another order); representative quaternions and
translations: atol 1e-4."""

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
from fccf_pcr_torch import interop
from fccf_pcr_torch.cluster import cluster as tcl
from fccf_pcr_torch.hypotheses.transforms import Hypotheses as THyp
from fccf_pcr_torch.ops import geometry as tgeo

from test_torch_hypotheses import jax_pair_faces


def _pool(rng, counts, H=2048, n_centers=12, spread_t=0.3, spread_deg=1.0):
    """A prefix-packed hypothesis pool: per type, noisy copies of a few
    pose centers, shuffled so clusters interleave."""
    quat, t, typ = [], [], []
    for ty, n in enumerate(counts):
        if n == 0:
            continue
        cq = rng.normal(size=(n_centers, 4))
        cq /= np.linalg.norm(cq, axis=1, keepdims=True)
        ct = rng.uniform(-3, 3, (n_centers, 3))
        pick = rng.integers(0, n_centers, n)
        dq = np.concatenate(
            [np.ones((n, 1)),
             rng.normal(0, np.deg2rad(spread_deg) / 2, (n, 3))], axis=1)
        q = np.asarray(jgeo.quat_multiply(jnp.asarray(dq, jnp.float32),
                                          jnp.asarray(cq[pick], jnp.float32)))
        quat.append(q / np.linalg.norm(q, axis=1, keepdims=True))
        t.append(ct[pick] + rng.normal(0, spread_t, (n, 3)))
        typ.append(np.full(n, ty))
    n = sum(counts)
    perm = rng.permutation(n)
    Q = np.zeros((H, 4), np.float32)
    T = np.zeros((H, 3), np.float32)
    Y = np.zeros(H, np.int32)
    if n:
        Q[:n] = np.concatenate(quat)[perm]
        T[:n] = np.concatenate(t)[perm]
        Y[:n] = np.concatenate(typ)[perm]
    valid = np.arange(H) < n
    return jtr.Hypotheses(
        quat=jnp.asarray(Q), t=jnp.asarray(T), type_=jnp.asarray(Y),
        valid=jnp.asarray(valid), count=jnp.int32(n), overflow=jnp.bool_(False),
    )


def check_cluster(hyp, params, caps):
    tparams = interop.params_from_reference(dataclasses.asdict(params))
    tcaps = interop.caps_from_reference(dataclasses.asdict(caps))
    thyp = interop.from_numpy(THyp, hyp)

    # The seed scan itself.
    H = hyp.valid.shape[0]
    xh = jnp.broadcast_to(jnp.array([1.0, 0, 0], jnp.float32), (H, 3))
    yh = jnp.broadcast_to(jnp.array([0, 1.0, 0], jnp.float32), (H, 3))
    masks = hyp.valid[None] & (hyp.type_[None] == jnp.arange(3)[:, None])
    js = jax.jit(lambda m, t, q: jcl._greedy_seeds_all_types(
        m, t, jgeo.quat_rotate(q, xh), jgeo.quat_rotate(q, yh), params
    ))(masks, hyp.t, hyp.quat)
    tq = thyp.quat
    ts = tcl._greedy_seeds_all_types(
        torch.from_numpy(np.array(masks)), thyp.t,
        tgeo.quat_rotate(tq, torch.tensor([1.0, 0, 0]).expand(H, 3)),
        tgeo.quat_rotate(tq, torch.tensor([0, 1.0, 0]).expand(H, 3)),
        tparams,
    )
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    np.testing.assert_allclose(ts[2].numpy(), np.asarray(js[2]),
                               rtol=1e-5, atol=1e-4)

    jr = jax.jit(lambda h: jcl.cluster_hypotheses(h, params, caps))(hyp)
    tr = tcl.cluster_hypotheses(thyp, tparams, tcaps)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    assert bool(tr.overflow) == bool(jr.overflow)
    np.testing.assert_allclose(tr.quat.numpy(), np.asarray(jr.quat), atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    return jr


@pytest.mark.parametrize(
    "counts", [(400, 250, 120), (0, 7, 300), (5, 0, 0), (0, 0, 0)],
    ids=["greedy", "identity+small+greedy", "pass-through", "empty"],
)
def test_synthetic_pools(counts):
    rng = np.random.default_rng(sum(counts))
    jr = check_cluster(_pool(rng, counts), FCCFParams(), TEST_CAPS)
    for ty, n in enumerate(counts):
        nv = int(np.asarray(jr.valid[ty]).sum())
        assert nv == (1 if n == 0 else n if n <= 10 else nv)


def test_pool_straddling_seed_blocks():
    """More than one 512-row seed block, with clusters across blocks."""
    rng = np.random.default_rng(4)
    check_cluster(_pool(rng, (700, 500, 300), n_centers=30),
                  FCCFParams(), TEST_CAPS)


@pytest.mark.parametrize("over", [dict(max_reps=8), dict(max_clusters=16)])
def test_capacity_overflow(over):
    rng = np.random.default_rng(5)
    jr = check_cluster(_pool(rng, (600, 300, 200), n_centers=60),
                       FCCFParams(), dataclasses.replace(TEST_CAPS, **over))
    assert bool(jr.overflow)


def test_pipeline_pool(small_pair, params, caps):
    f1, f2 = jax_pair_faces(small_pair, params, caps)
    hyp = jax.jit(lambda a, b: jtr.generate_hypotheses(
        a, b, jbases.select_bases(a, params), jbases.select_bases(b, params),
        params, caps))(f1, f2)
    jr = check_cluster(hyp, params, caps)
    assert int(np.asarray(jr.valid).sum()) > 10
