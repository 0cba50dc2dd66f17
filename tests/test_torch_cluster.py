"""Port hypothesis clustering against the JAX stage on identical
hypothesis pools (synthetic pools exercising every branch, and the
JAX package's pool of a synthetic pair).

Exact: greedy seeds, cluster sizes, representative validity/emission
order and the overflow flag. Cluster member sums: rtol 1e-5 / atol 1e-4
(matmul sums in another order); representative quaternions and
translations: atol 1e-4.

The cluster stage's loops (ops/cluster_kernels.py): the plain block
scan (block_scan_plain, the CPU's path and the plain version of the
card's C1) on a batch of two pools against the JAX stage (seeds and
sizes exact, sums within the tolerance above); the plain block seeds
(the fixpoint) against a sequential pass in index order as
csrc/cluster.cu's walk runs it, on random strictly lower-triangular
masks; the fixed-trip block scan against the scan that stops at the
batch's last occupied block (the JAX package's trip count), bit for bit;
the plain floor walk, and a chunked walk as C2 runs it, against the emit
mask of the JAX package's _emit_representatives; the kernels' wrappers
refuse a device that is neither the CPU nor a card."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fccf_pcr_tpu.cluster import cluster as jcl
from fccf_pcr_tpu.config import TEST_CAPS, FCCFParams
from fccf_pcr_tpu.hypotheses import bases as jbases
from fccf_pcr_tpu.hypotheses import transforms as jtr
from fccf_pcr_tpu.ops import geometry as jgeo
from fccf_pcr_torch import interop
from fccf_pcr_torch.cluster import cluster as tcl
from fccf_pcr_torch.hypotheses.transforms import Hypotheses as THyp
from fccf_pcr_torch.ops import cluster_kernels as ck
from fccf_pcr_torch.ops import geometry as tgeo
from fccf_pcr_torch.ops import graph as tgraph

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


# ------------------------------------------------- the cluster stage's loops


def _sequential_seeds(sub_lower, elig):
    """C1's walk (csrc/cluster.cu) in NumPy: coverage as 16-bit chunks,
    the next eligible and uncovered index found with the lowest set bit,
    its row ORed into the coverage, every index it covers skipped."""
    lead, B = elig.shape[:-1], elig.shape[-1]
    nc = -(-B // 16)

    def chunks(bits):  # (..., B) bool -> (..., nc) 16-bit ints
        pad = np.zeros(bits.shape[:-1] + (nc * 16,), bool)
        pad[..., :B] = bits
        return np.packbits(pad.reshape(bits.shape[:-1] + (nc, 16)), axis=-1,
                           bitorder="little").view("<u2")[..., 0].astype(int)

    out = np.zeros(elig.shape, bool)
    for lane in np.ndindex(*lead):
        e, rows = chunks(elig[lane]), chunks(sub_lower[lane])
        cov = np.zeros(nc, int)
        for c in range(nc):
            cand = int(e[c]) & ~int(cov[c]) & 0xFFFF
            while cand:
                b = (cand & -cand).bit_length() - 1
                out[lane + (16 * c + b,)] = True
                cov |= rows[16 * c + b]
                cand &= ~int(cov[c]) & ~((2 << b) - 1)
    return out


def _lower_masks(rng, lanes, B, density):
    sub = rng.uniform(size=(lanes, B, B)) < density
    return sub & np.triu(np.ones((B, B), bool), k=1)[None]


def _check_seeds(sub, elig):
    want = ck.block_seeds_plain(torch.from_numpy(sub), torch.from_numpy(elig))
    assert want.dtype == torch.bool and want.shape == elig.shape
    np.testing.assert_array_equal(_sequential_seeds(sub, elig), want.numpy())
    np.testing.assert_array_equal(
        ck.block_seeds(torch.from_numpy(sub), torch.from_numpy(elig)).numpy(),
        want.numpy())
    return want.numpy()


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 70),
       lanes=st.integers(1, 3), density=st.floats(0.0, 1.0),
       elig_p=st.floats(0.0, 1.0))
def test_sequential_block_seeds_equal_fixpoint(seed, B, lanes, density,
                                               elig_p):
    """The plain block seeds (the JAX package's fixpoint) equal a
    sequential pass in index order on random strictly lower-triangular
    masks, and every seed is eligible and covered by no earlier seed."""
    rng = np.random.default_rng(seed)
    sub = _lower_masks(rng, lanes, B, density)
    elig = rng.uniform(size=(lanes, B)) < elig_p
    s = _check_seeds(sub, elig)
    assert not (s & ~elig).any()
    covered = np.einsum("lj,lji->li", s.astype(int), sub.astype(int)) > 0
    np.testing.assert_array_equal(s, elig & ~covered)


@pytest.mark.parametrize("case", ["empty", "all eligible", "chain",
                                  "one ball", "no rows eligible"])
def test_block_seeds_edge_cases(case):
    """At the main path's B = 512: an empty mask (every eligible index is
    a seed), all eligible with random balls, one ball (index 0 covers
    every other: one seed), and no eligible row; a chain (i covers i + 1:
    seeds alternate, the fixpoint's slowest case, B rounds) at B = 200,
    a block that is no multiple of 16."""
    B = 200 if case == "chain" else 512
    rng = np.random.default_rng(B)
    sub = np.zeros((2, B, B), bool)
    elig = np.ones((2, B), bool)
    if case == "all eligible":
        sub = _lower_masks(rng, 2, B, 0.02)
    elif case == "chain":
        sub[:, np.arange(B - 1), np.arange(1, B)] = True
    elif case == "one ball":
        sub[:, 0, 1:] = True
    elif case == "no rows eligible":
        sub = _lower_masks(rng, 2, B, 0.5)
        elig[:] = False
    s = _check_seeds(sub, elig)
    n = {"empty": B, "chain": B // 2, "one ball": 1, "no rows eligible": 0}
    if case in n:
        assert (s.sum(-1) == n[case]).all(), s.sum(-1)


_jax_cluster = jax.jit(
    lambda h: jcl.cluster_hypotheses(h, FCCFParams(), TEST_CAPS))


def _bits(x):
    return x.numpy().view(np.int32) if x.dtype == torch.float32 else x.numpy()


@pytest.mark.parametrize("counts", [
    (400, 250, 120), (0, 7, 300), (5, 0, 0), (0, 0, 0), (700, 500, 300),
    ((700, 500, 300), (40, 30, 0))],
    ids=["greedy", "identity+small+greedy", "pass-through", "empty",
         "straddling", "batch of two lengths"])
def test_fixed_trip_scan_equals_dynamic_count(counts, monkeypatch):
    """The block scan over all H // 512 blocks (its trip count on a
    card) equals the scan that stops at the batch's last occupied block
    (the CPU's) bit for bit (seeds, sizes and member sums; blocks past
    it add only zeros to a sum that is never -0.0), and so does
    cluster_hypotheses. test_synthetic_pools and
    test_pool_straddling_seed_blocks hold the same pools to the JAX
    package's stage; here each row of a batch of two is held to it."""
    rng = np.random.default_rng(11)
    pools = [counts] if isinstance(counts[0], int) else list(counts)
    hyps = [_pool(rng, c, n_centers=30 if sum(c) > 1000 else 12)
            for c in pools]
    tparams = interop.params_from_reference(dataclasses.asdict(FCCFParams()))
    tcaps = interop.caps_from_reference(dataclasses.asdict(TEST_CAPS))
    th = [interop.from_numpy(THyp, h) for h in hyps]
    thyp = THyp(*(torch.stack([getattr(h, f) for h in th])
                  for f in THyp._fields))
    xh = tgeo.quat_rotate(thyp.quat, torch.tensor([1.0, 0, 0]).expand(
        thyp.t.shape))
    yh = tgeo.quat_rotate(thyp.quat, torch.tensor([0, 1.0, 0]).expand(
        thyp.t.shape))
    types = torch.arange(3, dtype=thyp.type_.dtype)
    masks = thyp.valid[..., None, :] & (thyp.type_[..., None, :]
                                        == types[:, None])
    H = masks.shape[-1]
    last = max([int(h.valid.nonzero().max()) for h in th if h.valid.any()],
               default=-1)
    n = ck.block_count(torch.amax(torch.where(masks, torch.arange(H), -1),
                                  dim=-1), H, 512)
    assert n == (last + 512) // 512 < H // 512  # two trip counts compared
    dyn = tcl._greedy_seeds_all_types(masks, thyp.t, xh, yh, tparams)
    want = tcl.cluster_hypotheses(thyp, tparams, tcaps)
    monkeypatch.setattr(ck, "block_count", lambda last_idx, H, B: H // B)
    fixed = tcl._greedy_seeds_all_types(masks, thyp.t, xh, yh, tparams)
    for a, b in zip(fixed, dyn):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    got = tcl.cluster_hypotheses(thyp, tparams, tcaps)
    for f, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    for k, hyp in enumerate(hyps if len(hyps) > 1 else []):
        jr = _jax_cluster(hyp)
        np.testing.assert_array_equal(got.valid[k].numpy(),
                                      np.asarray(jr.valid))
        assert bool(got.overflow[k]) == bool(jr.overflow)
        np.testing.assert_allclose(got.quat[k].numpy(), np.asarray(jr.quat),
                                   atol=1e-4)
        np.testing.assert_allclose(got.t[k].numpy(), np.asarray(jr.t),
                                   atol=1e-4)


def _chunked_walk(s_size, cn, chunk=8):
    """C2's walk (csrc/cluster.cu) in NumPy float32: the sizes taken in
    chunks, the carry (emitted, floor, stop) kept across them."""
    s_size = np.asarray(s_size, np.float32)
    cn = np.float32(cn)
    half = cn / np.float32(2.0)
    emit = np.zeros(s_size.shape, bool)
    emitted, floor = 0, max(np.float32(0.0), s_size[0])
    stop = False
    for c0 in range(0, len(s_size), chunk):
        for i in range(c0, min(c0 + chunk, len(s_size))):
            x = s_size[i]
            if stop or not x > 0:
                continue
            if x >= floor:
                emit[i] = True
                emitted += 1
                stop = np.float32(emitted) > cn
            elif np.float32(emitted) < half:
                floor = floor - np.float32(1.0)
                stop = floor < 2.0
            else:
                stop = True
        if stop:
            break
    return emit


def _walk_case(case, W=32):
    rng = np.random.default_rng(W)
    sizes = np.sort(rng.integers(1, 12, W))[::-1].astype(np.float32)
    cn = 8.0
    if case == "cluster_num 0":
        cn = 0.0
    elif case == "cluster_num 1":
        cn = 1.0
    elif case == "all sizes equal":
        sizes[:] = 5.0
        cn = 40.0
    elif case == "floor drops below 2":
        sizes = np.array([9, 3, 3, 3, 2, 2] + [1] * (W - 6), np.float32)
        cn = 40.0
    elif case == "empty tail slots":
        sizes[W // 3:] = 0.0
        cn = 30.0
    elif case == "no seed":
        sizes[:] = 0.0
    elif case == "one slot":
        sizes, cn = sizes[:1], 3.0
    return sizes, np.float32(cn)


_WALK_CASES = ["random", "cluster_num 0", "cluster_num 1", "all sizes equal",
               "floor drops below 2", "empty tail slots", "no seed",
               "one slot"]


def _jax_emit(sizes, cn):
    """The emit mask of the JAX package's _emit_representatives on sizes
    sorted descending: slot k's member sums are (k + 1) * size, so an
    emitted representative's mean translation names its slot."""
    W = len(sizes)
    sums = np.zeros((W, 9), np.float32)
    sums[:, 0] = (np.arange(W) + 1) * sizes
    sums[:, 3] = sums[:, 7] = 1.0
    caps = dataclasses.replace(TEST_CAPS, max_reps=W)
    r_valid, _, mean_t, _ = jcl._emit_representatives(
        jnp.asarray(sizes > 0), jnp.asarray(sizes), jnp.asarray(sums),
        jnp.float32(cn), caps)
    slots = np.asarray(mean_t)[np.asarray(r_valid), 0].astype(int) - 1
    emit = np.zeros(W, bool)
    emit[slots] = True
    return emit


@pytest.mark.parametrize("case", _WALK_CASES)
def test_floor_walk_equals_jax_emission(case):
    """The plain floor walk and C2's chunked walk equal the emit mask of
    the JAX package's scan: cluster_num 0 and 1, all sizes equal, a floor
    that drops below 2, empty tail slots, no seed and one slot."""
    sizes, cn = _walk_case(case)
    want = _jax_emit(sizes, cn)
    got = ck.floor_walk(torch.from_numpy(sizes), torch.tensor(cn))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_chunked_walk(sizes, cn), want)
    np.testing.assert_array_equal(_chunked_walk(sizes, cn, chunk=3), want)


def test_floor_walk_lanes_are_independent():
    """Every case as one (2, 4, W) batch of lanes: each lane's mask equals
    its walk alone."""
    W = 32
    cases = [_walk_case(c, W) for c in _WALK_CASES if c != "one slot"]
    cases = cases + cases[:1]
    sizes = np.stack([c[0] for c in cases]).reshape(2, 4, W)
    cn = np.array([c[1] for c in cases], np.float32).reshape(2, 4)
    got = ck.floor_walk_plain(torch.from_numpy(sizes), torch.from_numpy(cn))
    assert got.shape == (2, 4, W) and got.dtype == torch.bool
    for idx in np.ndindex(2, 4):
        np.testing.assert_array_equal(got[idx].numpy(),
                                      _jax_emit(sizes[idx], cn[idx]))


def test_cluster_kernels_refuse_other_devices():
    """A tensor on neither the CPU nor a card raises; nothing falls back."""
    sub = torch.zeros((1, 4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.block_seeds(sub, sub[..., 0])
    with pytest.raises(ValueError, match="unsupported device"):
        ck.floor_walk(torch.zeros((1, 4), device="meta"),
                      torch.zeros((1,), device="meta"))


def test_block_scan_plain_matches_jax():
    """block_scan_plain (the card's C1's plain version, the CPU's block
    scan) on a batch of two pools, one straddling three seed blocks and
    one with an empty type lane, each row against the JAX
    _greedy_seeds_all_types on the CPU: seeds and sizes exact, sums
    within rtol 1e-5, atol 1e-4 (check_cluster's: float32 sums in
    another order)."""
    rng = np.random.default_rng(12)
    pools = [_pool(rng, (700, 500, 300), n_centers=30),
             _pool(rng, (0, 7, 300))]
    params = FCCFParams()
    tparams = interop.params_from_reference(dataclasses.asdict(params))
    H = pools[0].valid.shape[0]
    xh = jnp.broadcast_to(jnp.array([1.0, 0, 0], jnp.float32), (H, 3))
    yh = jnp.broadcast_to(jnp.array([0, 1.0, 0], jnp.float32), (H, 3))
    want, inputs = [], []
    for hyp in pools:
        masks = hyp.valid[None] & (hyp.type_[None] == jnp.arange(3)[:, None])
        want.append(jax.jit(lambda m, t, q: jcl._greedy_seeds_all_types(
            m, t, jgeo.quat_rotate(q, xh), jgeo.quat_rotate(q, yh), params
        ))(masks, hyp.t, hyp.quat))
        tq = torch.from_numpy(np.array(hyp.quat))
        inputs.append((torch.from_numpy(np.array(masks)),
                       torch.from_numpy(np.array(hyp.t)),
                       tgeo.quat_rotate(tq, torch.tensor([1.0, 0, 0])
                                        .expand(H, 3)),
                       tgeo.quat_rotate(tq, torch.tensor([0, 1.0, 0])
                                        .expand(H, 3))))
    batch = [torch.stack(x) for x in zip(*inputs)]
    got = ck.block_scan_plain(*batch, tparams)
    assert ck.block_scan(*batch, tparams)[0].shape == (2, 3, H)
    for k, js in enumerate(want):
        np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(got[1][k].numpy(), np.asarray(js[1]))
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(js[2]),
                                   rtol=1e-5, atol=1e-4)
    assert not bool(got[0][1, 0].any())  # the empty lane has no seed
    assert int(got[0][0].sum()) > 0


def test_block_scan_refuses_other_devices():
    """The block scan on a tensor on neither the CPU nor a card raises
    before it launches anything; nothing falls back."""
    masks = torch.zeros((1, 3, 512), dtype=torch.bool, device="meta")
    x = torch.zeros((1, 512, 3), device="meta")
    before = ck.SCANS
    with pytest.raises(ValueError, match="unsupported device"):
        ck.block_scan(masks, x, x, x, FCCFParams())
    assert ck.SCANS == before


def test_count_launch_goes_to_the_capturing_graph(monkeypatch):
    """A counted launch adds one to its count, or, while this thread
    captures a graph, one to the graph's tally and nothing to the count
    (each replay adds the tally)."""
    import collections

    monkeypatch.setattr(ck, "SEEDS", 0)
    tgraph.count_launch(ck, "SEEDS")
    assert ck.SEEDS == 1
    tally = collections.Counter()
    monkeypatch.setattr(tgraph._CAPTURING, "tally", tally, raising=False)
    tgraph.count_launch(ck, "SEEDS")
    tgraph.count_launch(ck, "SEEDS")
    assert ck.SEEDS == 1 and tally == {(ck, "SEEDS"): 2}
