"""The port on a CUDA card: the label-prop propagation kernel (K1's sweep
and P1's path halving in one launch), the per-sweep host loop and the
gather kernel against their plain versions (label prop also at its edge
cases: bounds 0 and 1, no valid row, one component spanning every voxel,
only isolated voxels, V under one tile; under a cap on the sweeps; at the
widest slices; with no host sync), the main path on the card against the
port on the CPU, each row of a batch against its pair registered alone,
the host syncs of a batched step, the entry points' default device, a
batch split over one card listed twice against the unsplit batch, launch
counts kept across host threads, StageTimer's wait for the card, the
face-membership diff on the card against the CPU, the non-fused face
path on the card against the CPU, the kernel at measure_content's
V = 16384, and evaluate_config with escalation on the card against the
CPU; the LM loop run to its cap and replayed as a CUDA graph
(ops/graph.py's Graphs, the register step graph's machinery) against the
eager loop bit for bit, one capture a shape, LRU eviction, captures from
many host threads; the LM kernel L1 (refine/lm_kernel.py) against its
plain version lm_loop bit for bit (batches of 12, 96 and 192 lanes, 4,
16, 32, 33, 64, 200, 4097 and 40000 planes, 0, 1 and 50 iterations,
zero-weight, zero-cost and NaN lanes, lanes that accept every step and
lanes that reject most), a lane alone equal to it in a batch of 12 and
96, inside a capture, counted at each replay, launched once by
refine_pairs with no host sync; the cluster stage's kernels C1 (the
block scan: seeds, sizes and member sums, at H = 512-8192, batch 1 and
8, mixed pools, one type, an empty lane, a chain, non-finite entries),
the standalone block-seed walk and C2 (floor walk) against their plain
versions (C2 also at its edge lanes); K1's propagation with bounds far below V; the
register step replayed as one CUDA graph against the eager step
(_register_batch) bit for bit at the office and heritage presets and
over [cuda:0] * 2, with no host sync in a warm step; the scans S1
(cumsum, running max, reversed running min of bool, int32 and int64 rows)
and S2 (the base-16 blocked float prefix sum) against their plain
versions bit for bit, at row lengths 1 to 245760 (one tile, many tiles, a
ragged last tile), (16, 245760) and (1, n) rows, int values near 2^31,
-0.0, inf and NaN, inside a capture and counted at each replay; S2 on the
voxelization's leaf and moment columns formed in the kernel from their
sources against the plain prefix sum of the concatenated columns, at
lengths around its blocks of 256 and its levels' rows (4096, 65536), with
-0.0, inf, NaN and masked rows;
every scan kernel called twice in one captured graph replayed twice; the
faces stage's kernels F1 (the plane fit, its gates and orientation) and
F2 (the label segment sums, face statistics and values) against their
plain versions bit for bit (covariances of every kind, -0.0 and NaN
sources, V = 1 to 40000, inside a capture, one F1 and three F2 launches
in the face stage), and F1's cosf / atan2f against torch.cos /
torch.atan2 at every float32 of their domains in the plane fit; fine
verify's join (the lookup and counts, the places and the score, one
kernel) against its plain versions bit for bit on
tests/test_torch_fine_kernels.py's cases, each in the cluster size the
wrapper picks for it (1, 2, 4, 8 blocks or the scratch), a pair alone against its row of 8, twice in a replayed graph, and
once a step of register_pair; the hypotheses stage's kernels H1-H3 and
the bases form against their plain versions bit for bit (edge faces,
the overflows, H2's runs, H3 on chip_smoke.py's own H3 cases: the sizes
of --caps large and of escalated heritage caps, M 1001, H 0 and 1, H
below, at and above the total, a pair alone, 65535 pairs), a pair alone
against its batch, inside a capture.

This file imports no jax, so it runs on a machine without it (the
repository's conftest.py imports jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every test skips where torch.cuda.is_available() is false. Tolerances:
labels, status, face and hypothesis counts and kept masks exact; L1's
transforms exact (it does lm_loop's float32 operations in its order); the
transform within the golden band (0.1 deg / 0.02 m); scores rtol 1e-3
(float32 reductions run in another order on the card)."""

import numpy as np
import pytest
import torch

from fccf_pcr_torch import TEST_CAPS, FCCFParams, make_register_fn
from fccf_pcr_torch import registration_errors
from fccf_pcr_torch.io import synthetic
from fccf_pcr_torch.ops import cluster_kernels as ck
from fccf_pcr_torch.ops import faces_kernels as fk
from fccf_pcr_torch.ops import gather as gt
from fccf_pcr_torch.ops import graph
from fccf_pcr_torch.ops import label_prop as lp
from fccf_pcr_torch.ops import scan
from fccf_pcr_torch.pipeline.register import STEP
from fccf_pcr_torch.refine import lm_kernel as lmk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _clustered(rng, V, prefix, n_groups=5):
    gn = rng.normal(size=(n_groups, 3))
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    gc = rng.uniform(-10, 10, (n_groups, 3))
    which = rng.integers(0, n_groups, V)
    normal = (gn[which] + rng.normal(0, 0.01, (V, 3))).astype(np.float32)
    offsets = rng.uniform(-4, 4, (V, 3)).astype(np.float32)
    offsets -= (offsets * gn[which]).sum(1, keepdims=True) * gn[which]
    centroid = (gc[which] + offsets).astype(np.float32)
    valid = (np.arange(V) < prefix) & (rng.uniform(size=V) < 0.9)
    return normal, centroid, valid


@pytest.mark.parametrize("angle,l,k", [(5.0, 0.5, 5.0), (8.0, 1.0, 2.0)],
                         ids=["pass1", "pass2"])
def test_kernel_matches_plain_tail_and_bounds(cuda, angle, l, k):
    """V=700 (no block multiple), three pairs with bounds 700, 40 and 1,
    against the plain version on the card and on the CPU."""
    rng = np.random.default_rng(int(angle))
    bounds = (700, 40, 1)
    stats = [_clustered(rng, 700, b) for b in bounds]
    normal, centroid, valid = (
        torch.from_numpy(np.stack([s[i] for s in stats])) for i in range(3)
    )
    before = lp.PROPAGATIONS
    got = lp.label_propagate(
        normal.to(cuda), centroid.to(cuda), valid.to(cuda), angle, l, k,
        bound=torch.tensor(bounds, dtype=torch.int32, device=cuda),
    )
    torch.cuda.synchronize()
    assert lp.PROPAGATIONS == before + 1
    plain_gpu = lp.label_propagate_plain(
        normal.to(cuda), centroid.to(cuda), valid.to(cuda), angle, l, k
    )
    plain_cpu = lp.label_propagate(normal, centroid, valid, angle, l, k)
    np.testing.assert_array_equal(got.cpu().numpy(), plain_gpu.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), plain_cpu.numpy())


def test_kernel_matches_plain_at_building_scale(cuda):
    """The propagation kernel at the heritage preset's V=9216, two pairs
    with pass-1 and pass-2 sized bounds: one launch, and neither the
    one-sweep kernel nor the gather kernel."""
    rng = np.random.default_rng(9216)
    bounds = (8526, 100)
    stats = [_clustered(rng, 9216, b, n_groups=12) for b in bounds]
    normal, centroid, valid = (
        torch.from_numpy(np.stack([s[i] for s in stats])).to(cuda)
        for i in range(3)
    )
    k1, g, prop = lp.LAUNCHES, gt.LAUNCHES, lp.PROPAGATIONS
    got = lp.label_propagate(
        normal, centroid, valid, 5.0, 0.5, 5.0,
        bound=torch.tensor(bounds, dtype=torch.int32, device=cuda),
    )
    torch.cuda.synchronize()
    assert (lp.LAUNCHES, gt.LAUNCHES, lp.PROPAGATIONS) == (k1, g, prop + 1)
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_kernel_matches_plain_at_measurement_scale(cuda):
    """The propagation kernel at measure_content's V=16384 (a grid of 256
    row tiles), one pair with a pass-1 sized bound, against the plain
    version on the card."""
    rng = np.random.default_rng(16384)
    normal, centroid, valid = (
        torch.from_numpy(a[None]).to(cuda)
        for a in _clustered(rng, 16384, 15000, n_groups=16))
    before = lp.PROPAGATIONS
    got = lp.label_propagate(
        normal, centroid, valid, 5.0, 0.5, 5.0,
        bound=torch.tensor([15000], dtype=torch.int32, device=cuda),
    )
    torch.cuda.synchronize()
    assert lp.PROPAGATIONS == before + 1
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("V,bounds", [(1536, (200, 700, 40)),
                                      (9216, (1200, 3000, 100)),
                                      (16384, (2500, 900))])
def test_propagation_tiles_follow_the_bound(cuda, V, bounds):
    """The propagation kernel draws tiles from each pair's bound x bound
    square, sized from the bound: pairs with bound[p] far below V reach
    the plain labels at the office, heritage and measurement V."""
    rng = np.random.default_rng(V + len(bounds))
    arrays = [np.stack([c[i] for c in [_clustered(rng, V, b, n_groups=8)
                                       for b in bounds]]) for i in range(3)]
    normal, centroid, valid, bound = _on(cuda, arrays, bounds)
    before = lp.PROPAGATIONS
    got = lp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0,
                             bound=bound)
    torch.cuda.synchronize()
    assert lp.PROPAGATIONS == before + 1
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _one_plane(V):
    """Every voxel on the plane z = 0 with normal +z: every pair affine."""
    rng = np.random.default_rng(V)
    normal = np.tile(np.float32([0, 0, 1]), (V, 1))
    centroid = np.zeros((V, 3), np.float32)
    centroid[:, :2] = rng.uniform(-2, 2, (V, 2))
    return normal, centroid, np.ones(V, bool)


def _stacked_planes(V):
    """Parallel planes 10 apart: no pair affine."""
    normal, centroid, valid = _one_plane(V)
    centroid[:, 2] = 10.0 * np.arange(V)
    return normal, centroid, valid


def _edge_case(name):
    """(normal, centroid, valid) with a pair axis, and one bound a pair."""
    rng = np.random.default_rng(len(name))
    if name == "bounds_0_and_1":
        clouds = [_clustered(rng, 700, 0), _clustered(rng, 700, 1)]
        clouds[1][2][0] = True
        bounds = (0, 1)
    elif name == "no_valid_row":
        n, c, v = _clustered(rng, 700, 700)
        clouds, bounds = [(n, c, np.zeros_like(v))], (700,)
    elif name == "one_component":
        clouds, bounds = [_one_plane(1536)], (1536,)
    elif name == "only_isolated":
        clouds, bounds = [_stacked_planes(1536)], (1536,)
    else:  # V under one tile of rows (64) and of columns (32)
        V = int(name.split("_")[1])
        clouds, bounds = [_clustered(rng, V, V)], (V,)
    return [np.stack([c[i] for c in clouds]) for i in range(3)], bounds


@pytest.mark.parametrize("name", [
    "bounds_0_and_1", "no_valid_row", "one_component", "only_isolated",
    "V_40", "V_20"])
def test_kernel_matches_plain_at_edge_cases(cuda, name):
    (normal, centroid, valid), bounds = _edge_case(name)
    normal, centroid, valid = (torch.from_numpy(a).to(cuda)
                               for a in (normal, centroid, valid))
    got = lp.label_propagate(
        normal, centroid, valid, 5.0, 0.5, 5.0,
        bound=torch.tensor(bounds, dtype=torch.int32, device=cuda),
    )
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    n_comp = [len(np.unique(g[g < 2**30])) for g in want.cpu().numpy()]
    if name == "one_component":
        assert n_comp == [1]
    if name == "only_isolated":
        assert n_comp == [1536]


def _on(cuda, arrays, bounds):
    normal, centroid, valid = (torch.from_numpy(a).to(cuda) for a in arrays)
    return normal, centroid, valid, torch.tensor(bounds, dtype=torch.int32,
                                                 device=cuda)


@pytest.mark.parametrize("name", [
    "bounds_0_and_1", "no_valid_row", "one_component", "only_isolated",
    "V_40", "V_20"])
def test_host_loop_matches_plain_at_edge_cases(cuda, name):
    """The per-sweep host loop (one-sweep kernel + gather kernel), kept
    for A/B timing, reaches the plain labels too."""
    normal, centroid, valid, bound = _on(cuda, *_edge_case(name))
    k1, g = lp.LAUNCHES, gt.LAUNCHES
    got = lp._label_propagate_host_loop(normal, centroid, valid, 5.0, 0.5,
                                        5.0, bound, 32)
    torch.cuda.synchronize()
    assert lp.LAUNCHES > k1 and gt.LAUNCHES > g
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _propagate(normal, centroid, valid, bound, max_iters, jump_rounds=1):
    """One launch of the propagation kernel: (labels, sweeps run)."""
    stats, bound_t, labels = lp._kernel_inputs(normal, centroid, valid, bound)
    flags = torch.zeros((max_iters, labels.shape[0] + 1), dtype=torch.int32,
                        device=labels.device)
    sweeps = torch.zeros((1,), dtype=torch.int64, device=labels.device)
    lp._launch_propagate(stats, bound_t, labels, flags, sweeps,
                         lp.cos_deg(5.0), 0.5, 5.0, max_iters, jump_rounds)
    torch.cuda.synchronize()
    return labels, int(sweeps)


@pytest.mark.parametrize("max_iters", [1, 2, 32])
def test_propagation_respects_the_sweep_cap(cuda, max_iters):
    """A cap of 1 or 2 sweeps stops the device loop there; the labels are
    then an upper bound of the fixpoint (labels only fall) and no larger
    than the initial ones. Uncapped, it reaches the plain labels."""
    rng = np.random.default_rng(77)
    arrays = [np.stack([a]) for a in _clustered(rng, 9216, 8526, 12)]
    normal, centroid, valid, bound = _on(cuda, arrays, (8526,))
    got, sweeps = _propagate(normal, centroid, valid, bound, max_iters)
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    init = torch.where(valid, torch.arange(9216, device=cuda), 2**30)
    assert 1 <= sweeps <= max_iters
    assert bool((got >= want).all()) and bool((got <= init).all())
    if max_iters == 32:
        assert sweeps >= 2  # the last sweep lowers nothing
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("jump_rounds", [0, 3])
def test_propagation_any_halving_rounds(cuda, jump_rounds):
    (normal, centroid, valid), bounds = _edge_case("bounds_0_and_1")
    arrays = [np.concatenate([a, b[None]]) for a, b in zip(
        (normal, centroid, valid), _clustered(np.random.default_rng(3), 700,
                                              700))]
    normal, centroid, valid, bound = _on(cuda, arrays, bounds + (700,))
    got, _ = _propagate(normal, centroid, valid, bound, 32, jump_rounds)
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_propagation_at_the_widest_slices(cuda):
    """V = 12288 gets 512-column slices on an H100, the most shared memory
    a block of the cooperative grid asks for: it launches (every block
    co-resident) and reaches the plain labels."""
    V = 12288
    if lp.sweep_grid(V, lp._sm_count(cuda))[0] != 512:
        pytest.skip("this card's SM count gives narrower slices at V=12288")
    rng = np.random.default_rng(512)
    arrays = [np.stack([a]) for a in _clustered(rng, V, 11000, 12)]
    normal, centroid, valid, bound = _on(cuda, arrays, (11000,))
    got, sweeps = _propagate(normal, centroid, valid, bound, 32)
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    assert 1 <= sweeps <= 32
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_label_propagate_makes_no_host_sync(cuda):
    """label_propagate on CUDA tensors (the main path's form: a 0-d
    tensor bound) never waits for the card: CUDA's sync debug mode raises
    on any synchronizing call."""
    rng = np.random.default_rng(4)
    normal, centroid, valid = (torch.from_numpy(a).to(cuda)
                               for a in _clustered(rng, 1536, 1400))
    bound = torch.amax(torch.where(valid, torch.arange(1536, device=cuda),
                                   -1)) + 1
    lp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0, bound=bound)
    torch.cuda.synchronize()  # built and warm
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0,
                                 bound=bound)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("shape", [(1, 1024), (8, 9216)])
def test_gather_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[0])
    if shape == (1, 1024):  # tools/probe_gather.py's own inputs
        tbl = (np.arange(1024, dtype=np.int32) * 7)[None]
        idx = rng.integers(0, 1024, 1024).astype(np.int32)[None]
    else:
        tbl = rng.integers(0, 2**30, shape).astype(np.int32)
        idx = rng.integers(-3, shape[1] + 3, shape).astype(np.int32)
    before = gt.LAUNCHES
    got = gt.gather_rows(torch.from_numpy(tbl).to(cuda),
                         torch.from_numpy(idx).to(cuda))
    torch.cuda.synchronize()
    assert gt.LAUNCHES == before + 1
    want = np.take_along_axis(tbl, np.clip(idx, 0, shape[1] - 1), axis=1)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_gather_kernel_rejects_bad_inputs(cuda):
    tbl = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # wrong dtype
        gt.gather_rows(tbl.long(), tbl.long())
    with pytest.raises(ValueError):  # shapes differ
        gt.gather_rows(tbl, tbl[:, :32])


def test_kernel_rejects_bad_inputs(cuda):
    labels = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    changed = torch.zeros((1,), dtype=torch.int32, device=cuda)
    bound = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    stats = torch.zeros((1, 12, 64), device=cuda)
    with pytest.raises(ValueError):  # wrong dtype
        lp._launch_sweep(stats.double(), bound, labels, changed, 0.99, 0.5, 5.0)
    with pytest.raises(ValueError):  # not contiguous
        lp._launch_sweep(stats.transpose(1, 2).contiguous().transpose(1, 2),
                         bound, labels, changed, 0.99, 0.5, 5.0)
    with pytest.raises(ValueError):  # wrong device
        lp._launch_sweep(stats.cpu(), bound, labels, changed, 0.99, 0.5, 5.0)


def test_propagation_kernel_rejects_bad_inputs(cuda):
    labels = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    bound = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    stats = torch.zeros((1, 12, 64), device=cuda)
    flags = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    sweeps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    args = (0.99, 0.5, 5.0, 4)
    before = lp.PROPAGATIONS
    with pytest.raises(ValueError):  # wrong dtype
        lp._launch_propagate(stats.double(), bound, labels, flags, sweeps,
                             *args)
    with pytest.raises(ValueError):  # not contiguous
        lp._launch_propagate(stats.transpose(1, 2).contiguous().transpose(
            1, 2), bound, labels, flags, sweeps, *args)
    with pytest.raises(ValueError):  # wrong device
        lp._launch_propagate(stats, bound.cpu(), labels, flags, sweeps, *args)
    with pytest.raises(ValueError):  # flags not (max_iters, P + 1)
        lp._launch_propagate(stats, bound, labels, flags[:2], sweeps, *args)
    with pytest.raises(ValueError):  # sweep counter not int64
        lp._launch_propagate(stats, bound, labels, flags, sweeps.int(), *args)
    with pytest.raises(ValueError):  # negative halving rounds
        lp._launch_propagate(stats, bound, labels, flags, sweeps, *args, -1)
    assert lp.PROPAGATIONS == before


def test_make_register_fn_defaults_to_the_card(cuda):
    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.25)
    src, tar, _ = synthetic.make_pair(seed=3, points_per_plane=1500,
                                      clutter_points=900)
    args = synthetic.pad_points(src, caps.max_points) + synthetic.pad_points(
        tar, caps.max_points)
    before = lp.PROPAGATIONS
    res = make_register_fn(params, caps)(*args)
    assert res.transform.device.type == "cuda"
    assert lp.PROPAGATIONS > before


def test_register_pair_on_card_matches_cpu(cuda):
    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.25)
    args = []
    for seed in (3, 7):
        src, tar, _ = synthetic.make_pair(
            seed=seed, points_per_plane=1500, clutter_points=900
        )
        args.append(synthetic.pad_points(src, caps.max_points)
                    + synthetic.pad_points(tar, caps.max_points))
    batch = [np.stack([a[i] for a in args]) for i in range(4)]
    cpu = make_register_fn(params, caps, batched=True, device="cpu")(*batch)
    gpu_fn = make_register_fn(params, caps, batched=True, device=cuda)
    gpu = gpu_fn(*batch)
    again = gpu_fn(*batch)
    assert torch.equal(gpu.transform, again.transform)
    rre, rte = registration_errors(gpu.transform.cpu().double(),
                                   cpu.transform.double())
    assert float(rre.max()) < 0.1 and float(rte.max()) < 0.02
    for f in ("status", "n_faces", "n_hypotheses", "kept"):
        np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                      getattr(cpu, f).numpy(), err_msg=f)
    for f in ("quick_score", "fine_score"):
        np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(),
                                   getattr(cpu, f).numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=f)


# Pairs of different content (tests/test_torch_batch.py's): a clean room,
# a noisier room, noisy stairs whose residual overflows.
_BATCH_PAIRS = (dict(seed=0), dict(seed=2, noise=0.02),
                dict(seed=1, scene="stairs", noise=0.04))


def _batch(caps):
    args = []
    for kw in _BATCH_PAIRS:
        src, tar, _ = synthetic.make_pair(points_per_plane=1500,
                                          clutter_points=900, **kw)
        args.append(synthetic.pad_points(src, caps.max_points)
                    + synthetic.pad_points(tar, caps.max_points))
    return [np.stack([a[i] for a in args]) for i in range(4)]


def test_batch_rows_match_single_runs_on_card(cuda):
    """Row k of a batched step equals pair k registered alone on the card:
    status, kept mask, hypothesis and face counts equal, the transform
    within 1e-3 deg / 1e-4 m (chip_smoke.py's limit for the golden
    pairs)."""
    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.25)
    batch = _batch(caps)
    res = make_register_fn(params, caps, batched=True, device=cuda)(*batch)
    single = make_register_fn(params, caps, device=cuda)
    for k in range(len(_BATCH_PAIRS)):
        alone = single(*(a[k] for a in batch))
        for f in ("status", "kept", "n_hypotheses", "n_faces"):
            assert torch.equal(getattr(alone, f), getattr(res, f)[k]), (k, f)
        # The rotation angle from |R - R_row| (2 sqrt(2) sin(angle / 2)),
        # which is 0 for equal matrices, unlike the trace form.
        Ta, Tb = alone.transform.double(), res.transform[k].double()
        fro = float(torch.linalg.norm(Ta[:3, :3] - Tb[:3, :3]))
        deg = np.degrees(2.0 * np.arcsin(min(1.0, fro / (2.0 * np.sqrt(2.0)))))
        dist = float(torch.linalg.norm(Ta[:3, 3] - Tb[:3, 3]))
        assert deg <= 1e-3 and dist <= 1e-4, (k, deg, dist)
    assert res.status.tolist() == [0, 0, 16]


def test_batched_step_host_syncs_are_bounded(cuda):
    """A warm batched step waits for the card 0 times, whatever the batch
    size: it is one CUDA graph replay with its inputs on the card (label
    propagation, the cluster stage's loops and the LM loop all run on
    the device). Counted under CUDA's sync debug mode, which warns at
    each synchronizing call."""
    import warnings

    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.25)
    batch = [torch.from_numpy(a).to(cuda) for a in _batch(caps)]
    fn = make_register_fn(params, caps, batched=True, device=cuda)
    counts = []
    for P in (1, 3):
        args = [a[:P] for a in batch]
        fn(*args)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("called a synchronizing" in str(w.message)
                          for w in caught))
    assert counts == [0, 0], counts


def test_mesh_split_on_one_card_is_bitwise_equal(cuda):
    """A batch of 4 split over [cuda:0] * 2 (one card standing in for
    two) against the unsplit batch: every field bitwise equal."""
    from fccf_pcr_torch.parallel.mesh import make_mesh, make_sharded_register_fn

    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.25)
    batch = [np.concatenate([a, a[:1]]) for a in _batch(caps)]
    whole = make_register_fn(params, caps, batched=True, device=cuda)(*batch)
    fn = make_sharded_register_fn(params, caps, make_mesh(["cuda:0"] * 2))
    fn(*batch)  # captures the chunks' step graph
    before, replays = lp.PROPAGATIONS, STEP.replays
    split = fn(*batch)
    # two passes a chunk, counted at each replay of its step graph
    assert lp.PROPAGATIONS == before + 4
    assert STEP.replays == replays + 2
    for name, a, b in zip(split._fields, split, whole):
        assert a.device == b.device and torch.equal(a, b), name


def test_launch_counts_lose_nothing_across_threads(cuda):
    """More host threads than cores launching the propagation kernel at
    once, with a short switch interval: the count grows by exactly their
    launches (the counts are kept under a lock)."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(8)
    normal, centroid, valid = (torch.from_numpy(a).to(cuda)
                               for a in _clustered(rng, 700, 700))

    def work(_):
        for _ in range(25):
            lp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0)
        torch.cuda.synchronize()

    lp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0)  # built
    n = 2 * (os.cpu_count() or 4)
    before = lp.PROPAGATIONS
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n) as ex:
            for f in [ex.submit(work, i) for i in range(n)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert lp.PROPAGATIONS == before + n * 25


def test_stage_timer_waits_for_the_card(cuda):
    """A tensor inside a NamedTuple in the stage's list: on exit the card
    has finished the work that made it."""
    from fccf_pcr_torch.pipeline.register import RegistrationResult
    from fccf_pcr_torch.utils.profiling import StageTimer

    x = torch.randn((4096, 4096), device=cuda)
    torch.cuda.synchronize()
    t = StageTimer()
    with t.stage("matmuls") as live:
        y = x
        for _ in range(20):
            y = y @ x / 64.0
        live.append([RegistrationResult(*([y] * 9))])
        assert not torch.cuda.current_stream(cuda).query()  # still running
    assert torch.cuda.current_stream(cuda).query()
    assert t.times["matmuls"] > 0.0


def test_membership_diff_on_card_equals_cpu(cuda):
    """twin/diff.py's pipeline membership on the card (the propagation
    kernel) equals the CPU run's (the plain versions)."""
    from fccf_pcr_torch.twin import diff
    from fccf_pcr_torch.twin.families import FAMILIES

    cfg = FAMILIES["office"]
    _, tar, _ = synthetic.make_pair(seed=30, **cfg["scene"], **cfg["pair"])
    cloud = np.asarray(tar, np.float32)
    params = FCCFParams()
    before = lp.PROPAGATIONS
    on_card = diff._pipeline_membership(cloud, params, TEST_CAPS)
    assert lp.PROPAGATIONS > before
    assert on_card == diff._pipeline_membership(cloud, params, TEST_CAPS,
                                                device="cpu")
    res = diff.face_membership_diff(tar, params, TEST_CAPS)
    assert res["pair_agreement"] > 0.98 and res["matched_fraction"] > 0.95


def test_non_fused_path_on_card_matches_cpu(cuda):
    """A leaf that does not nest in the feature voxel (0.3 in 1.0) takes
    the non-fused face path: downsample, then voxel_stats. On the card it
    matches the port on the CPU."""
    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.3)
    src, tar, _ = synthetic.make_pair(seed=3, points_per_plane=1500,
                                      clutter_points=900)
    args = synthetic.pad_points(src, caps.max_points) + synthetic.pad_points(
        tar, caps.max_points)
    cpu = make_register_fn(params, caps, device="cpu")(*args)
    before = lp.PROPAGATIONS
    gpu = make_register_fn(params, caps, device=cuda)(*args)
    assert lp.PROPAGATIONS > before
    rre, rte = registration_errors(gpu.transform.cpu().double(),
                                   cpu.transform.double())
    assert float(rre) < 0.1 and float(rte) < 0.02
    for f in ("status", "n_faces", "n_hypotheses", "kept"):
        np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                      getattr(cpu, f).numpy(), err_msg=f)


def test_evaluate_config_on_card_matches_cpu(cuda):
    """evaluate_config with escalate_caps="auto" on the card against the
    CPU at TEST_CAPS, on a cluttered room whose residual overflows at
    seeds 1 and 2: status, flagged and failed seeds and n_escalated
    equal; RRE within 5e-3 deg (registration_errors runs in float32) and
    RTE within 1e-4 m."""
    from fccf_pcr_torch.evaluation.evaluate import evaluate_config

    cfg = dict(model="tiny",
               scene=dict(points_per_plane=550, clutter_points=2000,
                          noise=0.01, room=(10.0, 8.0, 3.0)),
               pair=dict())
    before = lp.PROPAGATIONS
    card = evaluate_config("room", cfg, 3, 2, escalate_caps="auto",
                           device=cuda)
    assert lp.PROPAGATIONS > before
    cpu = evaluate_config("room", cfg, 3, 2, escalate_caps="auto",
                          device="cpu")
    assert card["n_escalated"] >= 1
    for k in ("success", "fail_seeds", "flagged_seeds", "n_escalated"):
        assert card[k] == cpu[k], k
    for s, want in cpu["seed_rows"].items():
        got = card["seed_rows"][s]
        assert got["status"] == want["status"]
        assert abs(got["rre"] - want["rre"]) <= 5e-3
        assert abs(got["rte"] - want["rte"]) <= 1e-4


def _lm_lanes(seed, B, P=16):
    """Plane pairs under a small per-lane pose error with 2 cm of noise on
    the points (tests/test_torch_refine.py's candidates, noisy), a
    quarter of P masked; then a lane of zero weights, a lane at exactly
    zero cost and a lane with a NaN point."""
    rng = np.random.default_rng(seed)
    n1 = rng.normal(size=(B, P, 3))
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    p1 = rng.uniform(-5, 5, (B, P, 3))
    ang = rng.normal(0, 0.03, (B, 3))
    c, s = np.cos(ang[:, 2]), np.sin(ang[:, 2])
    R = np.zeros((B, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    n2 = np.einsum("bij,bpj->bpi", R, n1)
    p2 = (np.einsum("bij,bpj->bpi", R, p1) + rng.normal(0, 0.05, (B, 1, 3))
          + rng.normal(0, 0.02, (B, P, 3)))
    w = rng.uniform(0.05, 0.2, (B, P))
    w[:, P - P // 4:] = 0.0
    w[B - 3] = 0.0
    n2[B - 2], p2[B - 2] = n1[B - 2], p1[B - 2]
    p1[B - 1, min(5, P - 1), 1] = np.nan
    return [a.astype(np.float32) for a in (n1, p1, n2, p2, w)]


def _on_card(arrays, dev):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _lm_graph(graphs, *args, iters=50):
    """The LM loop run to its cap through ``graphs``: captured once per
    shape, then replayed."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    return graphs.replay(gn.lm_loop, args, (iters, False))


@pytest.mark.parametrize("B", [12, 96])
def test_lm_graph_equals_eager_loop(cuda, B):
    """The LM loop to its cap replayed as a CUDA graph against the eager
    loop, with and without its early exit, and against refine_pairs on
    the card (the loop to its cap, eagerly), on the same inputs: bit for
    bit (the same kernels in the same order). The replay's inputs are
    copies: changing the caller's tensors after the call changes
    nothing."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    graphs = graph.Graphs(max_graphs=4)
    args = _on_card(_lm_lanes(B, B), cuda)
    got = _lm_graph(graphs, *args)
    again = _lm_graph(graphs, *args)
    assert torch.equal(got, gn.refine_pairs(*args))
    for early_exit in (False, True):
        assert torch.equal(got, gn.lm_loop(*args, early_exit=early_exit))
    assert torch.equal(got, again)
    assert torch.equal(got[-3:].cpu(), torch.eye(4).expand(3, 4, 4))
    assert bool(torch.isfinite(got).all())


def test_lm_graph_one_capture_a_shape(cuda):
    """One capture per (shape, dtype, iters) on a device, every call a
    replay; a view of an expanded tensor (quick.py's inputs) replays the
    graph of its shape."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    graphs = graph.Graphs(max_graphs=16)
    a = _on_card(_lm_lanes(1, 24), cuda)
    b = _on_card(_lm_lanes(2, 48), cuda)
    _lm_graph(graphs, *a)
    _lm_graph(graphs, *a)
    _lm_graph(graphs, *b)
    _lm_graph(graphs, *a, iters=10)
    view = [x[:1].expand((24,) + x.shape[1:]) for x in a]
    got = _lm_graph(graphs, *view)
    assert graphs.captures == 3 and graphs.replays == 5
    assert graphs.cached(cuda) == 3
    assert torch.equal(got, gn.lm_loop(*(x.contiguous() for x in view),
                                       early_exit=False))


def test_lm_graph_cache_evicts_least_recent(cuda):
    """With room for two graphs, a third shape evicts the least recently
    used one, whose next call captures again; clear() gives back the
    graphs' memory pools."""
    graphs = graph.Graphs(max_graphs=2)
    shapes = {B: _on_card(_lm_lanes(B, B), cuda) for B in (6, 9, 12)}
    _lm_graph(graphs, *shapes[6])
    _lm_graph(graphs, *shapes[9])
    _lm_graph(graphs, *shapes[6])     # 6 is now the most recent
    _lm_graph(graphs, *shapes[12])    # evicts 9
    assert graphs.cached(cuda) == 2 and graphs.captures == 3
    _lm_graph(graphs, *shapes[6])     # still kept
    assert graphs.captures == 3
    _lm_graph(graphs, *shapes[9])     # captured again, evicts 12
    assert graphs.captures == 4 and graphs.cached(cuda) == 2
    torch.cuda.synchronize()
    held = graph.pool_bytes(cuda)
    graphs.clear()
    torch.cuda.empty_cache()
    assert held > 0 and graph.pool_bytes(cuda) < held
    assert graphs.cached() == 0


def test_lm_graph_captures_from_many_host_threads(cuda):
    """As parallel/mesh.py runs devices, under stress: more host threads
    than cores capturing and replaying four shapes at once, with a short
    switch interval, while one more thread runs the eager loop with its
    host syncs (capture_error_mode="thread_local"). Every result equals
    the eager loop's, and the counts lose nothing: one capture a shape,
    one replay a call (kept under locks)."""
    import os
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from fccf_pcr_torch.refine import gauss_newton as gn

    graphs = graph.Graphs(max_graphs=16)
    shapes = (15, 18, 21, 27)
    inputs = {B: _on_card(_lm_lanes(B, B), cuda) for B in shapes}
    want = {B: gn.lm_loop(*a, early_exit=False) for B, a in inputs.items()}
    n, reps = 2 * (os.cpu_count() or 4), 3
    start = threading.Barrier(n + 1)

    def replays(i):
        start.wait()
        B = shapes[i % len(shapes)]
        got = [_lm_graph(graphs, *inputs[B]) for _ in range(reps)]
        torch.cuda.synchronize()
        return B, got

    def eager():
        start.wait()
        return {B: gn.lm_loop(*inputs[B]) for B in (15, 27)}

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n + 1) as ex:
            jobs = [ex.submit(replays, i) for i in range(n)]
            side = ex.submit(eager)
            results = [j.result(timeout=300) for j in jobs]
            eager_res = side.result(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    for B, got in results:
        for g in got:
            assert torch.equal(g, want[B]), B
    for B, got in eager_res.items():
        assert torch.equal(got, want[B]), B
    assert graphs.captures == len(shapes)
    assert graphs.replays == n * reps
    assert graphs.cached(cuda) == len(shapes)


def test_refine_pairs_makes_no_host_sync(cuda):
    """refine_pairs on the card launches L1 once and never waits for the
    card, so a capture can take it: CUDA's sync debug mode raises on any
    synchronizing call."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    args = _on_card(_lm_lanes(5, 30), cuda)
    gn.refine_pairs(*args)
    torch.cuda.synchronize()
    before = lmk.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gn.refine_pairs(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lmk.LAUNCHES == before + 1
    assert torch.equal(got, gn.lm_loop(*args))


@pytest.mark.parametrize("B,P", [(12, 16), (96, 16), (192, 16), (12, 4),
                                 (96, 4), (24, 32), (12, 25), (12, 33),
                                 (96, 33), (12, 64), (96, 64), (12, 200),
                                 (96, 200), (4, 4096)])
@pytest.mark.parametrize("iters", [0, 1, 50])
def test_lm_kernel_matches_plain(cuda, B, P, iters):
    """L1 against lm_loop on the card, to its cap and with its early exit:
    bit for bit, the zero-weight, zero-cost and NaN lanes (the last three)
    at the identity; every lane's LM steps within the cap, and none for
    those three. Up to 32 planes L1 keeps them in registers; 33, 64, 200
    and 4096 (MAX_PLANES) take its scratch instantiation (rows of 132 to
    16384 entries in torch.sum, folds of as many rows; from 8192 entries
    torch splits a row over its block's height). At 25 planes and 12
    lanes torch's reduce block is 64 threads wide (fewer than 16 rows to
    sum)."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    args = _on_card(_lm_lanes(B + P, B, P), cuda)
    before = lmk.LAUNCHES
    got = lmk.refine_lm(*args, iters)
    assert lmk.LAUNCHES == before + 1
    for early_exit in (False, True):
        assert torch.equal(got, gn.lm_loop(*args, iters,
                                           early_exit=early_exit))
    assert torch.equal(got[-3:].cpu(), torch.eye(4).expand(3, 4, 4))
    steps = lmk.lm_solve(*args, iters)[2].cpu()
    assert int(steps.min()) >= 0 and int(steps.max()) <= iters
    assert steps[-3:].tolist() == [0, 0, 0]
    if iters:
        assert int(steps.max()) > 0


@pytest.mark.parametrize("B,P", [(12, 4), (96, 16), (12, 25), (24, 32)])
def test_lm_kernel_scratch_instantiation_matches_registers(cuda, B, P):
    """Where the planes fit in registers, L1's scratch instantiation
    (planes and rows through global memory) gives the registers one's q,
    t and steps bit for bit, and both lm_loop's transforms: the two add
    in the same order."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    args = _on_card(_lm_lanes(B + 7 * P, B, P), cuda)
    regs = lmk.lm_solve(*args, 50, registers=True)
    scratch = lmk.lm_solve(*args, 50, registers=False)
    for a, b in zip(regs, scratch):
        assert torch.equal(a, b)
    assert torch.equal(lmk.refine_lm(*args), gn.lm_loop(*args))


@pytest.mark.parametrize("P", [4097, 40000])
def test_lm_kernel_takes_any_number_of_planes(cuda, P):
    """L1 has no cap on the planes a lane: 4097 (one above the cap it had)
    and 40000 (4F = 160000 residual rows, above the 130560 entries from
    which torch's reduce splits a row over several blocks) against
    lm_loop to its cap and with its early exit, bit for bit, with the
    zero-weight, zero-cost and NaN lanes."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    args = _on_card(_lm_lanes(P, 5, P), cuda)
    got = lmk.refine_lm(*args, 20)
    for early_exit in (False, True):
        assert torch.equal(got, gn.lm_loop(*args, 20, early_exit=early_exit))
    assert torch.equal(got[-3:].cpu(), torch.eye(4).expand(3, 4, 4))
    steps = lmk.lm_solve(*args, 20)[2].cpu()
    assert steps[-3:].tolist() == [0, 0, 0] and int(steps.max()) > 0


@pytest.mark.parametrize("P", [16, 33])
def test_lm_kernel_lane_alone_equals_batch(cuda, P):
    """A lane's q, t and LM steps are the same bits alone (Bt = 1), in a
    launch of 12 lanes and in one of 96: nothing L1 does depends on the
    other lanes of its launch. lm_loop on the card gives the same
    transforms at every batch size."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    args = _on_card(_lm_lanes(P + 96, 96, P), cuda)
    full = lmk.lm_solve(*args, 50)
    twelve = lmk.lm_solve(*(a[36:48] for a in args), 50)
    for a, b in zip(twelve, full):
        assert torch.equal(a, b[36:48])
    want = gn.lm_loop(*args, 50, early_exit=False)
    assert torch.equal(gn.lm_loop(*(a[36:48] for a in args), 50,
                                  early_exit=False), want[36:48])
    for lane in (0, 40, 93, 94, 95):
        alone = lmk.lm_solve(*(a[lane:lane + 1] for a in args), 50)
        for a, b in zip(alone, full):
            assert torch.equal(a[0], b[lane]), lane
        assert torch.equal(
            gn.lm_loop(*(a[lane:lane + 1] for a in args), 50,
                       early_exit=False)[0], want[lane]), lane
    assert torch.equal(lmk.refine_lm(*args, 50), want)


def _noise_free_lanes(seed, B, P):
    """_lm_lanes' plane pairs with no noise on the points: the LM accepts
    its first steps, each a large decrease of the cost."""
    rng = np.random.default_rng(seed)
    n1 = rng.normal(size=(B, P, 3))
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    p1 = rng.uniform(-5, 5, (B, P, 3))
    ang = rng.normal(0, 0.05, B)
    c, s = np.cos(ang), np.sin(ang)
    R = np.zeros((B, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    n2 = np.einsum("bij,bpj->bpi", R, n1)
    p2 = np.einsum("bij,bpj->bpi", R, p1) + rng.normal(0, 0.1, (B, 1, 3))
    w = rng.uniform(0.05, 0.2, (B, P))
    return [a.astype(np.float32) for a in (n1, p1, n2, p2, w)]


@pytest.mark.parametrize("kind,iters", [("accepting", 2), ("rejecting", 50),
                                        ("rejecting", 200)])
@pytest.mark.parametrize("P", [16, 40])
def test_lm_kernel_accepting_and_rejecting_lanes(cuda, kind, iters, P):
    """Lanes that accept every step they run (no noise, 2 iterations:
    each a large decrease) and lanes that reject most of theirs (noisy: a
    few accepted steps, then rejections while lam doubles up to its 1e8
    cap, where the step no longer changes; 200 iterations keep them
    there for 150 more): L1 against lm_loop, bit for bit, and L1's counts
    of steps and accepted steps."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    make = _noise_free_lanes if kind == "accepting" else _lm_lanes
    args = _on_card(make(P + iters, 24, P), cuda)
    got = lmk.refine_lm(*args, iters)
    assert torch.equal(got, gn.lm_loop(*args, iters, early_exit=False))
    _, _, steps, accepted = (x.cpu() for x in lmk.lm_solve(*args, iters))
    if kind == "accepting":
        assert steps.tolist() == [iters] * 24
        assert torch.equal(accepted, steps)
    else:
        assert int((steps == iters).sum()) >= 6
        assert int(accepted.sum()) * 4 < int(steps.sum())


def test_lm_kernel_inside_a_capture(cuda):
    """L1 captured as a graph (as inside the register step's) equals the
    eager launch, and its launch counts once at each replay."""
    graphs = graph.Graphs(max_graphs=1)
    args = _on_card(_lm_lanes(7, 48), cuda)
    want = lmk.refine_lm(*args)
    got = graphs.replay(lmk.refine_lm, args)  # warm-up + capture + replay
    before = lmk.LAUNCHES
    again = [graphs.replay(lmk.refine_lm, args) for _ in range(2)]
    torch.cuda.synchronize()
    assert lmk.LAUNCHES == before + 2
    assert all(torch.equal(x, want) for x in [got, *again])


def test_lm_kernel_rejects_bad_inputs(cuda):
    """On CUDA tensors too, what L1 does not take raises before a launch
    (tests/test_torch_refine.py holds each check on the CPU)."""
    n = torch.zeros((3, 16, 3), device=cuda)
    w = torch.zeros((3, 16), device=cuda)
    before = lmk.LAUNCHES
    with pytest.raises(ValueError, match="p1 wants"):  # another device
        lmk.lm_solve(n, n.cpu(), n, n, w)
    with pytest.raises(ValueError, match="F = 0"):  # no plane
        m = torch.zeros((3, 0, 3), device=cuda)
        lmk.lm_solve(m, m, m, m, torch.zeros((3, 0), device=cuda))
    assert lmk.LAUNCHES == before


# ------------------------------------------- the cluster stage's kernels


def _lower(rng, lanes, B, density):
    sub = rng.uniform(size=(lanes, B, B)) < density
    return sub & np.triu(np.ones((B, B), bool), k=1)[None]


@pytest.mark.parametrize("lanes,B,density,elig_p", [
    (24, 512, 0.01, 0.9), (24, 512, 0.3, 0.5), (3, 512, 0.0, 1.0),
    (6, 200, 0.05, 0.8), (1, 1, 0.0, 1.0), (5, 16, 1.0, 1.0)])
def test_block_seeds_kernel_matches_plain(cuda, lanes, B, density, elig_p):
    """C1 against the plain fixpoint on the card: random strictly lower
    triangular masks at the main path's B = 512 and batch 8 (24 lanes),
    an empty mask, a block that is no multiple of 16, one index, and a
    full mask."""
    rng = np.random.default_rng(lanes * B)
    sub = torch.from_numpy(_lower(rng, lanes, B, density)).to(cuda)
    elig = torch.from_numpy(rng.uniform(size=(lanes, B)) < elig_p).to(cuda)
    before = ck.SEEDS
    got = ck.block_seeds(sub, elig)
    torch.cuda.synchronize()
    assert ck.SEEDS == before + 1
    assert torch.equal(got, ck.block_seeds_plain(sub, elig))


def test_block_seeds_kernel_chain_and_one_ball(cuda):
    """A chain (i covers i + 1: every other index a seed) and one ball
    (index 0 covers all: one seed), on a (2, 3) lane batch."""
    B = 512
    sub = torch.zeros((2, 3, B, B), dtype=torch.bool, device=cuda)
    ar = torch.arange(B - 1, device=cuda)
    sub[0, :, ar, ar + 1] = True
    sub[1, :, 0, 1:] = True
    elig = torch.ones((2, 3, B), dtype=torch.bool, device=cuda)
    got = ck.block_seeds(sub, elig)
    assert torch.equal(got, ck.block_seeds_plain(sub, elig))
    assert got[0].sum(-1).tolist() == [B // 2] * 3
    assert got[1].sum(-1).tolist() == [1] * 3


def _walk_inputs(rng, lanes, W):
    sizes = np.sort(rng.integers(0, 40, (lanes, W)), axis=-1)[:, ::-1]
    sizes = sizes.astype(np.float32).copy()
    cn = rng.integers(0, 60, lanes).astype(np.float32)
    cn[:4] = (0.0, 1.0, 200.0, 2.0)
    sizes[1] = 7.0  # all equal
    sizes[2, W // 5:] = 0.0  # empty tail
    sizes[3] = 0.0  # no seed
    head = np.float32([9, 3, 3, 3, 2, 2, 1, 1])[:W]
    sizes[4] = 1.0
    sizes[4, :len(head)] = head  # the floor drops below 2
    cn[4] = 40.0
    return sizes, cn


@pytest.mark.parametrize("lanes,W", [(24, 2048), (24, 6144), (6, 5000),
                                     (5, 1)])
def test_floor_walk_kernel_matches_plain(cuda, lanes, W):
    """C2 against the plain walk on the card: the office / heritage and
    structured widths at batch 8, a width that is no multiple of the
    kernel's chunk, one slot; cluster_num 0, 1 and large, all sizes
    equal, an empty tail, no seed, a floor that drops below 2."""
    rng = np.random.default_rng(W)
    sizes, cn = _walk_inputs(rng, max(lanes, 5), W)
    s = torch.from_numpy(sizes[:lanes]).to(cuda)
    c = torch.from_numpy(cn[:lanes]).to(cuda)
    before = ck.WALKS
    got = ck.floor_walk(s, c)
    torch.cuda.synchronize()
    assert ck.WALKS == before + 1
    assert torch.equal(got, ck.floor_walk_plain(s, c))
    assert torch.equal(ck.floor_walk(s.reshape(-1, 1, W)[:, 0], c), got)


def _walk_edge(name):
    """(s_size, cluster_num) of one C2 edge lane batch."""
    f32 = np.float32
    if name == "no seed":
        return np.zeros((3, 100), f32), f32([0, 5, 100])
    if name == "W = 1":
        return f32([[3], [0], [1]]), f32([0, 1, 5])
    if name == "W = 8192":
        s = np.sort(np.random.default_rng(8192).integers(0, 9, (24, 8192)),
                    axis=-1)[:, ::-1].astype(f32)
        return np.ascontiguousarray(s), np.full(24, 4000, f32)
    if name == "W = 1000 (no multiple of 32)":
        s = np.sort(np.random.default_rng(1000).integers(0, 30, (6, 1000)),
                    axis=-1)[:, ::-1].astype(f32)
        return np.ascontiguousarray(s), f32([0, 1, 20, 60, 500, 2000])
    if name == "ties at the floor":
        s = np.full((2, 96), 5, f32)
        s[1, 40:] = 4
        return s, f32([1000, 1000])
    if name == "stop over the budget":
        return np.full((2, 80), 6, f32), f32([10, 40])
    if name == "stop below a floor of 2":
        s = np.full((2, 80), 1, f32)
        s[:, 0] = (9, 2)
        return s, f32([100, 100])
    if name == "stop at half the budget":
        s = np.full((2, 80), 3, f32)
        s[:, 0] = 9
        s[1, :20] = 9
        return s, f32([2, 30])
    if name == "stop in the last slot of a round":
        s = np.full((3, 96), 1, f32)
        s[0, :32] = 7   # the 32nd emit is over a budget of 31: slot 31
        s[1, :31] = 2   # slot 31 lowers the floor from 2 to 1
        s[2, :63] = 7   # slot 63 emits nothing at 63 >= half of 100
        return s, f32([31, 100, 100])
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "no seed", "W = 1", "W = 8192", "W = 1000 (no multiple of 32)",
    "ties at the floor", "stop over the budget", "stop below a floor of 2",
    "stop at half the budget", "stop in the last slot of a round"])
def test_floor_walk_kernel_edge_lanes(cuda, name):
    """C2 against the plain walk on the card at its edges: every slot a
    non-seed, one slot, 8192 slots, a width that is no multiple of 32,
    ties at the floor, each of the walk's three stops, and a stop in the
    last slot of a round of 32."""
    sizes, cn = _walk_edge(name)
    s = torch.from_numpy(sizes).to(cuda)
    c = torch.from_numpy(cn).to(cuda)
    got = ck.floor_walk(s, c)
    assert torch.equal(got, ck.floor_walk_plain(s, c))


def test_cluster_kernels_reject_bad_inputs(cuda):
    sub = torch.zeros((2, 64, 64), dtype=torch.bool, device=cuda)
    elig = torch.zeros((2, 64), dtype=torch.bool, device=cuda)
    before = (ck.SEEDS, ck.WALKS)
    with pytest.raises(ValueError):  # mask not (..., B, B)
        ck.block_seeds(sub[:, :32], elig)
    with pytest.raises(ValueError):  # block over 512
        ck.block_seeds(torch.zeros((1, 520, 520), dtype=torch.bool,
                                   device=cuda),
                       torch.zeros((1, 520), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):  # wrong dtype
        ck.floor_walk(torch.zeros((2, 8), dtype=torch.float64, device=cuda),
                      torch.zeros((2,), device=cuda))
    with pytest.raises(ValueError):  # budgets on another device
        ck.floor_walk(torch.zeros((2, 8), device=cuda), torch.zeros((2,)))
    assert (ck.SEEDS, ck.WALKS) == before


def _scan_pool(seed, P, H, kind):
    """A batch of P hypothesis pools of capacity H for the block scan:
    masks (P, 3, H), t, px, py (P, H, 3), with FCCFParams' gates
    (cluster_dist 0.8, cluster_angle 2 deg). Poses cluster around a few
    centers a pool; the valid prefix ends inside the last block. kind:
    "mixed" (three types), "one type" (every hypothesis type 0),
    "empty lane" (no type 2), "chain" (type 0 in runs of 8 on lines 0.75
    apart, the runs 3 apart: each covers the next of its run only), "nonfinite" (a NaN in one valid px, an inf in
    an invalid slot's t)."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((P, 3, H), bool)
    t = np.zeros((P, H, 3), np.float32)
    ang = np.zeros((P, H))
    for p in range(P):
        n = H - int(rng.integers(1, min(H, 300)))
        if kind == "chain":
            i = np.arange(n)
            t[p, :n] = np.stack([0.75 * (i % 8), 3.0 * ((i // 8) % 50),
                                 3.0 * (i // 400)], -1)
            typ = np.zeros(n, int)
        else:
            centers = rng.uniform(-6, 6, (max(2, n // 40), 3))
            pick = rng.integers(0, len(centers), n)
            t[p, :n] = centers[pick] + rng.normal(0, 0.4, (n, 3))
            ang[p, :n] = (rng.integers(0, 4, n) * 0.5
                          + rng.normal(0, 0.01, n))
            typ = rng.integers(0, 3 if kind != "empty lane" else 2, n)
            if kind == "one type":
                typ[:] = 0
        masks[p, typ, np.arange(n)] = True
    c, s = np.cos(ang), np.sin(ang)
    z = np.zeros_like(c)
    px = np.stack([c, s, z], -1).astype(np.float32)
    py = np.stack([-s, c, z], -1).astype(np.float32)
    if kind == "nonfinite":
        px[0, 3, 1] = np.nan
        t[P - 1, H - 1, 2] = np.inf
    return masks, t, px, py


def _nan_equal(a, b):
    return a.shape == b.shape and bool(torch.all(
        (a == b) | (torch.isnan(a) & torch.isnan(b))))


_SCAN_CASES = [(H, P, kind) for H in (512, 2048, 3072, 8192) for P in (1, 8)
               for kind in ("mixed", "one type", "empty lane")] + [
    (H, P, kind) for H, P in ((512, 1), (2048, 8))
    for kind in ("chain", "nonfinite")]


@pytest.mark.parametrize("H,P,kind", _SCAN_CASES)
def test_block_scan_kernel_matches_plain(cuda, H, P, kind):
    """C1, the whole block scan, against block_scan_plain (the PyTorch
    block loop) on the card: seeds exactly equal, sizes and member sums
    equal bit for bit (a NaN where the plain version has one), one
    launch whatever H // 512 is. Every H and batch at the three pool
    kinds; the chain and the non-finite entries at one block and at an
    office-sized batch."""
    params = FCCFParams()
    masks, t, px, py = _on_card(_scan_pool(H + P, P, H, kind), cuda)
    before = ck.SCANS
    got = ck.block_scan(masks, t, px, py, params)
    torch.cuda.synchronize()
    assert ck.SCANS == before + 1
    want = ck.block_scan_plain(masks, t, px, py, params)
    assert torch.equal(got[0], want[0])
    assert _nan_equal(got[1], want[1]) and _nan_equal(got[2], want[2])
    if kind == "chain":  # every other hypothesis of a run is a seed
        n = int(masks[0, 0].sum())  # the last one is never eligible
        assert int(got[0][0, 0].sum()) == sum(i % 2 == 0 for i in
                                              np.arange(n - 1) % 8)
    if kind == "nonfinite":
        assert bool(torch.isnan(got[2]).any())


def test_block_scan_kernel_rejects_bad_inputs(cuda):
    params = FCCFParams()
    masks, t, px, py = _on_card(_scan_pool(0, 2, 512, "mixed"), cuda)
    before = ck.SCANS
    with pytest.raises(ValueError):  # t on another device
        ck.block_scan(masks, t.cpu(), px, py, params)
    with pytest.raises(ValueError):  # float64
        ck.block_scan(masks, t.double(), px, py, params)
    with pytest.raises(ValueError):  # no multiple of the block
        ck.block_scan(torch.zeros((2, 3, 600), dtype=torch.bool,
                                  device=cuda),
                      *(torch.zeros((2, 600, 3), device=cuda),) * 3, params)
    assert ck.SCANS == before


# ------------------------------------------- the register step as a graph


def _preset_batch(name, seeds, dev):
    """configs.CONFIGS[name]'s scenes for ``seeds`` through one batched
    pre_downsample a side, as chip_smoke.py's config_batch."""
    from fccf_pcr_torch import pre_downsample
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS[name]["model"])
    pairs = configs.pairs_for_config(configs.CONFIGS[name], seeds)
    args = []
    for side in range(2):
        p, m = zip(*(synthetic.pad_points(pair[side], model.caps.raw_points)
                     for pair in pairs))
        pts, mask, _ = pre_downsample(np.stack(p), np.stack(m), model.params,
                                      model.caps, device=dev)
        args += [pts, mask]
    return model, args


def _fields_equal(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert x.device == y.device and torch.equal(x, y), f


@pytest.mark.parametrize("name", ["office", "heritage"])
def test_step_graph_equals_eager_step(cuda, name):
    """make_register_fn on the card (the step replayed as one CUDA graph)
    against _register_batch (the eager step) on the same batch of 4:
    every field bitwise equal; one capture, then a replay a call; C1 (one
    block-scan launch), C2, L1 and the propagation kernel counted at each
    replay."""
    from fccf_pcr_torch.pipeline.register import _register_batch

    model, args = _preset_batch(name, [0, 1, 2, 3], cuda)
    fn = make_register_fn(model.params, model.caps, batched=True,
                          device=cuda)
    STEP.clear()
    c0 = STEP.captures
    first = fn(*args)
    counts = (lp.PROPAGATIONS, ck.SCANS, ck.WALKS, lmk.LAUNCHES,
              STEP.replays, ck.SEEDS)
    again = fn(*args)
    torch.cuda.synchronize()
    # One block-scan launch a step whatever H // 512 is, and no
    # standalone block-seed launch.
    assert (lp.PROPAGATIONS, ck.SCANS, ck.WALKS, lmk.LAUNCHES,
            STEP.replays, ck.SEEDS) == (counts[0] + 2, counts[1] + 1,
                                        counts[2] + 1, counts[3] + 1,
                                        counts[4] + 1, counts[5])
    assert STEP.captures == c0 + 1
    eager = _register_batch(*args, model.params, model.caps)
    _fields_equal(first, eager)
    _fields_equal(again, eager)


def test_step_graph_split_equals_eager_split(cuda):
    """The office batch of 4 over make_mesh([cuda:0] * 2) (each chunk a
    replay of the step graph) against the eager step of each chunk:
    every field bitwise equal."""
    from fccf_pcr_torch.parallel.mesh import make_mesh, make_sharded_register_fn
    from fccf_pcr_torch.pipeline.register import (RegistrationResult,
                                                  _register_batch)

    model, args = _preset_batch("office", [0, 1, 2, 3], cuda)
    split = make_sharded_register_fn(model.params, model.caps,
                                     make_mesh(["cuda:0"] * 2))(*args)
    chunks = [_register_batch(*(a[k:k + 2] for a in args), model.params,
                              model.caps) for k in (0, 2)]
    eager = RegistrationResult(*(torch.cat(f) for f in zip(*chunks)))
    _fields_equal(split, eager)


def test_warm_step_makes_no_host_sync(cuda):
    """A warm step (its graph captured) never waits for the card: CUDA's
    sync debug mode raises on any synchronizing call."""
    model, args = _preset_batch("office", [0, 1], cuda)
    fn = make_register_fn(model.params, model.caps, batched=True,
                          device=cuda)
    want = fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _fields_equal(got, want)


def test_refine_pairs_inside_a_capture_runs_inline(cuda):
    """refine_pairs captured as a graph (as inside the register step's)
    runs L1 inline, and the replay equals the eager call and the eager
    loop with its early exit."""
    from fccf_pcr_torch.refine import gauss_newton as gn

    args = _on_card(_lm_lanes(6, 18), cuda)
    want = gn.refine_pairs(*args)
    got = graph.Graphs(max_graphs=1).replay(gn.refine_pairs, args)
    assert torch.equal(got, want)
    assert torch.equal(got, gn.lm_loop(*args))


# ------------------------------------------------------------ S1 and S2 --

SCAN_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 1024, 1025, 4095, 4096, 4097,
                8192, 8193, 12288, 65536, 245760)


def _scan_inputs(n, seed):
    """Rows of length n as the step's scans see them, and edge rows:
    ((name, tensor) pairs): flags (random, all false, all true), int32
    values near 2^31 with sentinel tails, int64 values around 2^31, a
    batch of 16 rows and a batch of 1."""
    rng = np.random.default_rng(seed)
    lead = (2, 3) if n <= 65536 else (16,)
    flags = rng.uniform(size=lead + (n,)) < 0.3
    flags[..., 0, :] = False
    flags[..., -1, :] = True
    big = rng.integers(2**31 - 2**20, 2**31 - 1, lead + (n,),
                       dtype=np.int64)
    big[..., 0, :] = -big[..., 0, :]
    idx = np.arange(n)
    tail = np.where(rng.uniform(size=lead + (n,)) < 0.2, idx, 2**31 - 1)
    tail[..., idx >= n - n // 3] = 2**31 - 1
    wide = rng.integers(-2**40, 2**40, (1, n), dtype=np.int64) + 2**31
    return (("flags", torch.from_numpy(flags)),
            ("int32 near 2^31", torch.from_numpy(big.astype(np.int32))),
            ("int32 sentinel tail", torch.from_numpy(tail.astype(np.int32))),
            ("int64 near 2^31", torch.from_numpy(big)),
            ("int64 sentinel tail", torch.from_numpy(tail)),
            ("int64 one row", torch.from_numpy(wide)))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_int_scan_kernel_matches_plain(cuda, n):
    """S1 == torch.cumsum / torch.cummax / flip-cummin-flip on the card,
    bit for bit, one call a count: rows of one tile, of exactly k tiles
    of 1024 and one entry more or less, and many rows."""
    fns = {scan.SUM: scan.cumsum, scan.MAX: scan.cummax,
           scan.MIN_REVERSED: scan.rev_cummin}
    for what, x in _scan_inputs(n, n):
        x = x.to(cuda)
        for op, fn in fns.items():
            if op != scan.SUM and x.dtype == torch.bool:
                continue
            before = scan.INT_SCANS
            got = fn(x)
            assert scan.INT_SCANS == before + 1
            want = scan.int_scan_plain(x, op)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), (what, op)
    x = _scan_inputs(n, 1)[4][1].to(cuda)
    head = torch.cat([x, x[..., :5]], dim=-1)[..., :n]  # rows a stride apart
    assert torch.equal(scan.cummax(head), scan.int_scan_plain(x, scan.MAX))


def _float_rows(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    x[..., 0] = -0.0
    if shape[-1] > 1:
        x[..., 1] = np.where(rng.uniform(size=shape[:-1]) < 0.5, -0.0, 0.0)
    x[rng.uniform(size=shape) < 1e-3] = np.inf
    x[rng.uniform(size=shape) < 1e-3] = -np.inf
    x[rng.uniform(size=shape) < 1e-3] = np.nan
    return torch.from_numpy(x)


@pytest.mark.parametrize("shape", [
    (1, 1, 4), (2, 2, 4), (2, 15, 10), (2, 16, 4), (2, 17, 4), (3, 255, 10),
    (3, 256, 4), (3, 257, 10), (2, 4097, 4), (2, 65536, 10), (1, 65537, 3),
    (16, 245760, 4), (16, 245760, 10), (1, 300001, 1), (2, 4097, 20),
    (1, 300, 33)])
def test_prefix_sum_kernel_matches_plain(cuda, shape):
    """S2 == the plain blocked prefix sum on the card, every bit (signed
    zeros and the card's NaNs included), one call a launch count; more
    than 16 columns take several column groups."""
    x = _float_rows(shape, sum(shape)).to(cuda)
    before = scan.PREFIX_SUMS
    got = scan.prefix_sum(x, dim=1)
    assert scan.PREFIX_SUMS == before + 1
    want = scan.prefix_sum_plain(x, dim=1).contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # Along dim 0 of a 2-D tensor and dim -2 of a 4-D one.
    x2 = x[0]
    assert torch.equal(scan.prefix_sum(x2).view(torch.int32),
                       scan.prefix_sum_plain(x2).contiguous()
                       .view(torch.int32))
    x4 = x[None]
    assert torch.equal(scan.prefix_sum(x4, dim=-2).view(torch.int32),
                       want[None].view(torch.int32))


FUSED_SHAPES = ((1, 1), (2, 17), (2, 256), (2, 257), (2, 4095), (2, 4096),
                (3, 4097),
                (1, 65535), (1, 65536), (2, 65537), (1, 65536 + 4096 * 3 - 1),
                (1, 65536 + 4096 * 3 + 1), (16, 245760))


def _fused_sources(B, n, seed):
    """The fused prefix sums' sources: coordinates with -0.0, inf and
    NaN, some in masked rows (x * 0.0 gives -0.0 or NaN there), a row of
    all-false flags; p zero off the mask for the moments, as
    down_anchored is."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (B, n, 3)).astype(np.float32)
    p[rng.uniform(size=p.shape) < 1e-2] = -0.0
    p[rng.uniform(size=p.shape) < 1e-3] = np.inf
    p[rng.uniform(size=p.shape) < 1e-3] = np.nan
    mask = rng.uniform(size=(B, n)) < 0.7
    mask[0, : n // 3] = False
    first = rng.uniform(size=(B, n)) < 0.2
    first[:, 0] = True
    down = np.where(mask[..., None], p, 0.0).astype(np.float32)
    return [torch.from_numpy(a) for a in (p, mask, first, down)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_prefix_sums_match_plain(cuda, shape):
    """S2 on the voxelization's leaf and moment columns formed in the
    kernel == the plain prefix sum of the concatenated columns, every bit
    (signed zeros and the card's NaNs included), one call a count."""
    p, mask, first, down = (t.to(cuda) for t in _fused_sources(*shape,
                                                               sum(shape)))
    px, py, pz = p.unbind(-1)
    before = scan.PREFIX_SUMS
    got = scan.leaf_prefix_sums(px, py, pz, mask, first)
    assert scan.PREFIX_SUMS == before + 1
    want = scan.leaf_sums_plain(px, py, pz, mask, first)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    got = scan.moment_prefix_sums(down, mask)
    assert scan.PREFIX_SUMS == before + 2
    want = scan.moment_sums_plain(down, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # Coordinates that are not zero off the mask: the products as they are.
    got = scan.moment_prefix_sums(p, mask)
    want = scan.moment_sums_plain(p, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_scan_kernels_replay_twice_in_one_capture(cuda):
    """Each kernel called twice inside one captured graph and the graph
    replayed twice: every replay equals the eager calls (a call's scratch
    may be another's, freed, in the graph's pool)."""
    x = _scan_inputs(12289, 9)[4][1].to(cuda)
    p, mask, first, down = (t.to(cuda) for t in _fused_sources(2, 20000, 9))
    px, py, pz = p.unbind(-1)

    def fn(x, px, py, pz, mask, first, down):
        out = []
        for _ in range(2):
            out += [scan.cumsum(x), scan.cummax(x), scan.rev_cummin(x),
                    scan.leaf_prefix_sums(px, py, pz, mask, first),
                    scan.moment_prefix_sums(down, mask)]
        return tuple(out)

    args = (x, px, py, pz, mask, first, down)
    want = fn(*args)
    graphs = graph.Graphs(max_graphs=1)
    graphs.replay(fn, args)  # the capture
    for _ in range(2):
        got = graphs.replay(fn, args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)
    graphs.clear()


def test_scan_kernels_in_a_capture(cuda):
    """S1 and S2 captured in a CUDA graph: each replay equals the eager
    calls, and the launches count at each replay."""
    x = _scan_inputs(4097, 5)[4][1].to(cuda)
    f = _float_rows((2, 4097, 10), 5).to(cuda)

    def fn(x, f):
        return (scan.cumsum(x), scan.cummax(x), scan.rev_cummin(x),
                scan.prefix_sum(f, dim=1))

    graphs = graph.Graphs(max_graphs=1)
    want = fn(x, f)
    graphs.replay(fn, (x, f))  # the capture
    ints, sums = scan.INT_SCANS, scan.PREFIX_SUMS
    for _ in range(2):
        got = graphs.replay(fn, (x, f))
    torch.cuda.synchronize()
    assert scan.INT_SCANS == ints + 6 and scan.PREFIX_SUMS == sums + 2
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))
    graphs.clear()


def _bits(t):
    """A float tensor's bits (signed zeros and the card's NaNs apart)."""
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _all_equal(got, want):
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_faces_math_matches_torch(cuda):
    """F1's cosf and atan2f (faces_kernels.math_probe) == torch.cos and
    torch.atan2 on the card, bit for bit: cos at every float32 in [0, pi]
    (the plane fit's phases) and atan2 at every r in [-1, 1] with y =
    sqrt((1 - r)(1 + r)) as eigen3 forms it, then random float32 pairs of
    any magnitude, inf and NaN."""
    step = 1 << 26
    top = int(np.array(np.pi, np.float32).view(np.int32))
    for lo in range(0, top + 1, step):
        x = torch.arange(lo, min(lo + step, top + 1), dtype=torch.int32,
                         device=cuda).view(torch.float32)
        got, _ = fk.math_probe(x, x)
        assert torch.equal(_bits(got), _bits(torch.cos(x))), lo
    one = int(np.array(1.0, np.float32).view(np.int32))
    for sign in (0, -(1 << 31)):
        for lo in range(0, one + 1, step):
            bits = torch.arange(lo, min(lo + step, one + 1), dtype=torch.int32,
                                device=cuda) + sign
            r = bits.view(torch.float32)
            y = torch.sqrt(((1.0 - r) * (r + 1.0)).double()).float()
            _, got = fk.math_probe(r, y)
            assert torch.equal(_bits(got), _bits(torch.atan2(y, r))), lo
    g = torch.Generator(device=cuda).manual_seed(3)
    bits = torch.randint(-2**31, 2**31 - 1, (2, 1 << 24), generator=g,
                         device=cuda, dtype=torch.int64).to(torch.int32)
    x, y = bits.view(torch.float32)
    c, a = fk.math_probe(x, y)
    assert torch.equal(_bits(c), _bits(torch.cos(x)))
    assert torch.equal(_bits(a), _bits(torch.atan2(y, x)))


def _covariances(rng, n):
    """n covariances of every kind the plane fit meets: random planar and
    not, zero, isotropic, rank-1 and rank-2, -0.0 off-diagonals with a
    negative eigenvalue, tiny and huge scales, NaN and inf entries."""
    R = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    ev = rng.uniform(0.01, 1.0, (n, 3))
    ev[: n // 2, 0] = rng.uniform(1e-6, 1e-3, n // 2)
    cov = np.einsum("nij,nj,nkj->nik", R, ev, R).astype(np.float32)
    kinds = rng.integers(0, 10, n)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    for i in np.flatnonzero(kinds == 0):
        cov[i] = 0.0
    for i in np.flatnonzero(kinds == 1):
        cov[i] = np.eye(3, dtype=np.float32) * rng.uniform(0.1, 2.0)
    for i in np.flatnonzero(kinds == 2):
        cov[i] = np.outer(u[i], u[i])
    for i in np.flatnonzero(kinds == 3):
        v = rng.normal(size=3).astype(np.float32)
        cov[i] = np.outer(u[i], u[i]) + np.outer(v, v)
    for i in np.flatnonzero(kinds == 4):
        cov[i] = np.diag(rng.uniform(-1.0, 1.0, 3)).astype(np.float32)
        cov[i][~np.eye(3, dtype=bool)] = -0.0
    for i in np.flatnonzero(kinds == 5):
        cov[i] *= np.float32(10.0 ** rng.choice([-30, -20, -8, 8, 20]))
    for i in np.flatnonzero(kinds == 6):
        cov[i].flat[rng.integers(0, 9)] = rng.choice([np.nan, np.inf, -np.inf])
    return cov


def _plane_inputs(B, V, seed):
    rng = np.random.default_rng(seed)
    cov = _covariances(rng, B * V).reshape(B, V, 3, 3)
    centroid = rng.uniform(-5, 5, (B, V, 3)).astype(np.float32)
    centroid[rng.uniform(size=(B, V)) < 0.01] = np.nan
    count = rng.integers(0, 12, (B, V)).astype(np.int32)
    valid = rng.uniform(size=(B, V)) < 0.8
    gcent = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    return [torch.from_numpy(a) for a in (cov, centroid, count, valid, gcent)]


@pytest.mark.parametrize("B,V", [(1, 1), (2, 37), (16, 1536), (16, 9216),
                                 (1, 40000)])
def test_plane_fit_kernel_matches_plain(cuda, B, V):
    """F1 == plane_fit_plain on the card, every output bit for bit, one
    launch a call: covariances of every kind (_covariances), counts
    around the threshold, invalid voxels, NaN centroids."""
    args = [t.to(cuda) for t in _plane_inputs(B, V, B + V)]
    before = fk.PLANE_FITS
    got = fk.plane_fit(*args, 5, 0.04)
    assert fk.PLANE_FITS == before + 1
    want = fk.plane_fit_plain(*args, 5, 0.04)
    assert _all_equal(got, want)


def _stat_inputs(B, V, seed, kind="random"):
    """Face-stat sources: labels (component min slots, _BIG where
    invalid; ``kind`` "random", "singletons" (one-voxel faces), "one"
    (one face of every voxel), "wide" (labels past V), "negative" (labels
    below 0), "past" (every valid row labelled V or above) or "runs"
    (labels in sorted runs of 1-70 rows from the first row, so labels
    start where no power of two lies between their length and their end:
    their -0.0 sums stay -0.0)), valid, counts (0 in places, so negative
    coordinates give -0.0 columns), centroids and normals with -0.0 and
    NaN."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(B, V)) < 0.85
    if kind == "negative":
        labels = rng.integers(-V, V, (B, V))
    elif kind == "past":
        labels = rng.integers(V, 3 * V, (B, V))
    elif kind == "runs":
        cuts = np.cumsum(rng.integers(1, 71, V))
        labels = np.broadcast_to(np.searchsorted(cuts, np.arange(V),
                                                 side="right"), (B, V)).copy()
        valid[:] = True
    elif kind == "random":
        labels = np.minimum(rng.integers(0, max(V // 7, 1), (B, V)),
                            np.arange(V))
    elif kind == "singletons":
        labels = np.broadcast_to(np.arange(V), (B, V)).copy()
    elif kind == "one":
        labels = np.zeros((B, V), np.int64)
        valid[:] = True
    else:
        labels = rng.integers(0, 2 * V, (B, V))
    labels = np.where(valid, labels, 2**30).astype(np.int64)
    count = rng.integers(0, 40, (B, V)).astype(np.int32)
    centroid = rng.normal(size=(B, V, 3)).astype(np.float32)
    normal = rng.normal(size=(B, V, 3)).astype(np.float32)
    for a in (centroid, normal):
        a[rng.uniform(size=a.shape) < 0.05] = -0.0
        a[rng.uniform(size=a.shape) < 0.002] = np.nan
        if kind == "runs":
            a[rng.uniform(size=a.shape) < 0.5] = -0.0
    return [torch.from_numpy(a) for a in (labels, valid, count, centroid,
                                          normal)]


FACE_CASES = [(1, 1, "random"), (1, 1, "one"), (2, 37, "random"),
              (3, 300, "singletons"), (2, 300, "wide"), (16, 1536, "random"),
              (16, 9216, "random"), (4, 12000, "random"),
              (1, 40000, "one"), (1, 40000, "random"), (2, 700, "negative"),
              (2, 300, "past"), (2, 2100, "runs"), (2, 16384, "random"),
              (1, 16384, "singletons"), (1, 40000, "runs")]


@pytest.mark.parametrize("B,V,kind", FACE_CASES)
def test_face_stats_kernel_matches_plain(cuda, B, V, kind):
    """F2's face statistics == face_stats_plain on the card, every output
    bit for bit, one launch a call: -0.0 and NaN sources, invalid rows,
    one-voxel faces, one face of every voxel (V = 40000: the rows do not
    fit in shared memory), labels past V, V not a power of two."""
    labels, valid, count, centroid, normal = (
        t.to(cuda) for t in _stat_inputs(B, V, B * V, kind))
    before = fk.SEGMENT_SUMS
    got = fk.face_stats(labels, valid, count, centroid, normal, V)
    assert fk.SEGMENT_SUMS == before + 1
    seg_s, order = fk.sorted_labels(labels, valid, V)
    want = fk.face_stats_plain(seg_s, order, count, centroid, normal, valid,
                               V)
    assert _all_equal(got, want)


@pytest.mark.parametrize("B,V,kind", FACE_CASES)
def test_segment_sum_kernel_matches_plain(cuda, B, V, kind):
    """F2's values form == values_sum_plain on the card, bit for bit:
    angles with -0.0 (kept only where no add touches the row) and NaN
    with its sign bit set."""
    labels, valid, _, centroid, _ = (
        t.to(cuda) for t in _stat_inputs(B, V, B + V, kind))
    values = centroid[..., 0].contiguous()
    values[..., ::5] = -0.0
    values[..., 1::97] = -float("nan")
    if kind == "runs":
        values[..., ::2] = -0.0
    before = fk.SEGMENT_SUMS
    got = fk.label_segment_sum(values, labels, valid, V)
    assert fk.SEGMENT_SUMS == before + 1
    seg_s, order = fk.sorted_labels(labels, valid, V)
    assert _all_equal((got,), (fk.values_sum_plain(seg_s, order, values,
                                                   V),))


@pytest.mark.parametrize("B,V,kind", FACE_CASES)
def test_label_order_matches_torch_sort(cuda, B, V, kind):
    """F2's own stable order (faces_kernels.label_order, one launch, the
    blocks of the sum forms) == torch.sort(seg, stable=True): the same
    seg_s and the same position of every row."""
    labels, valid = (t.to(cuda) for t in _stat_inputs(B, V, B + 2 * V,
                                                      kind)[:2])
    before = fk.ORDERS
    got = fk.label_order(labels, valid, V)
    assert fk.ORDERS == before + 1
    want = fk.sorted_labels(labels, valid, V)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_label_order_refuses_labels_below_int32(cuda):
    """A valid label below -2^31, which F2's 32-bit keys do not order,
    raises in label_order; the sums drop its row and stay the plain bits."""
    labels, valid, count, centroid, normal = (
        t.to(cuda) for t in _stat_inputs(2, 700, 5, "negative"))
    labels[:, ::13] -= 2**33
    valid[:, ::13] = True
    with pytest.raises(ValueError, match="below -2"):
        fk.label_order(labels, valid, 700)
    seg_s, order = fk.sorted_labels(labels, valid, 700)
    assert _all_equal(fk.face_stats(labels, valid, count, centroid, normal,
                                    700),
                      fk.face_stats_plain(seg_s, order, count, centroid,
                                          normal, valid, 700))


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_segment_sums_alike_at_any_split(cuda, splits):
    """F2 on clouds of n = 1152 S - 52 rows, which it splits over S blocks
    (one a 1152 rows, up to 8), gives the plain bits, and its order there
    is torch.sort's."""
    n = 1152 * splits - 52
    for kind in ("random", "runs", "negative"):
        labels, valid, count, centroid, normal = (
            t.to(cuda) for t in _stat_inputs(3, n, splits, kind))
        seg_s, order = fk.sorted_labels(labels, valid, n)
        got = fk.face_stats(labels, valid, count, centroid, normal, n)
        assert _all_equal(got, fk.face_stats_plain(
            seg_s, order, count, centroid, normal, valid, n))
        values = centroid[..., 2].contiguous()
        got = fk.label_segment_sum(values, labels, valid, n)
        assert _all_equal((got,), (fk.values_sum_plain(seg_s, order, values,
                                                        n),))
        got = fk.label_order(labels, valid, n)
        assert torch.equal(got[0], seg_s) and torch.equal(got[1], order)


def test_faces_kernels_in_a_capture(cuda):
    """F1 and both forms of F2 captured in a CUDA graph (each twice),
    replayed twice: every replay equals the eager calls and the launches
    count at each replay."""
    fit_args = [t.to(cuda) for t in _plane_inputs(4, 1536, 1)]
    labels, valid, count, centroid, normal = (
        t.to(cuda) for t in _stat_inputs(4, 1536, 2))
    big = [t.to(cuda) for t in _stat_inputs(1, 20000, 3)]
    ang = centroid[..., 1].contiguous()

    def fn(*a):
        fit = a[:5]
        lab, val, cnt, cen, nrm, ang, blab, bval, bcnt, bcen, bnrm = a[5:]
        out = []
        for _ in range(2):
            out += [*fk.plane_fit(*fit, 5, 0.04),
                    *fk.face_stats(lab, val, cnt, cen, nrm, 1536),
                    fk.label_segment_sum(ang, lab, val, 1536),
                    *fk.face_stats(blab, bval, bcnt, bcen, bnrm, 20000)]
        return tuple(out)

    args = (*fit_args, labels, valid, count, centroid, normal, ang, *big)
    want = fn(*args)
    graphs = graph.Graphs(max_graphs=1)
    graphs.replay(fn, args)  # the capture
    fits, sums = fk.PLANE_FITS, fk.SEGMENT_SUMS
    for _ in range(2):
        got = graphs.replay(fn, args)
        torch.cuda.synchronize()
        assert _all_equal(got, want)
    assert fk.PLANE_FITS == fits + 4 and fk.SEGMENT_SUMS == sums + 12
    graphs.clear()


def test_faces_kernels_reject_bad_inputs(cuda):
    fit_args = [t.to(cuda) for t in _plane_inputs(2, 64, 4)]
    with pytest.raises(ValueError):
        fk.plane_fit(fit_args[0].double(), *fit_args[1:], 5, 0.04)
    with pytest.raises(ValueError):
        fk.plane_fit(*fit_args[:2], fit_args[2].long(), *fit_args[3:], 5,
                     0.04)
    labels, valid, count, centroid, normal = (
        t.to(cuda) for t in _stat_inputs(2, 64, 5))
    with pytest.raises(ValueError):
        fk.face_stats(labels, valid, count.long(), centroid, normal, 64)
    with pytest.raises(ValueError):
        fk.label_segment_sum(centroid[..., 0].double(), labels, valid, 64)
    with pytest.raises(ValueError):
        fk.label_segment_sum(centroid[..., 0], labels.int(), valid, 64)
    with pytest.raises(ValueError):
        fk.face_stats(labels, valid[:, :32], count, centroid, normal, 64)
    with pytest.raises(ValueError):
        fk.math_probe(centroid[..., 0].cpu(), centroid[..., 0].cpu())


def test_faces_from_voxels_launches_f1_and_f2(cuda):
    """The face stage on the card launches F1 once and F2 three times (the
    two face statistics and the roughness) and runs no plain version and
    no sort by label (F2 orders the rows itself)."""
    from fccf_pcr_torch.features import faces

    src, _, _ = synthetic.make_pair(seed=1, points_per_plane=400,
                                    clutter_points=200)
    pts, mask = synthetic.pad_points(src, TEST_CAPS.max_points)
    params = FCCFParams(leaf_size=0.25)
    args = (torch.from_numpy(pts).to(cuda), torch.from_numpy(mask).to(cuda))
    fits, sums = fk.PLANE_FITS, fk.SEGMENT_SUMS
    plain = []
    kept = (fk.plane_fit_plain, fk.face_stats_plain, fk.values_sum_plain,
            fk.sorted_labels)
    (fk.plane_fit_plain, fk.face_stats_plain, fk.values_sum_plain,
     fk.sorted_labels) = ((lambda *a: plain.append(a)),) * 4
    try:
        got = faces.extract_faces(*args, params, TEST_CAPS)
    finally:
        (fk.plane_fit_plain, fk.face_stats_plain, fk.values_sum_plain,
         fk.sorted_labels) = kept
    torch.cuda.synchronize()
    assert fk.PLANE_FITS == fits + 1 and fk.SEGMENT_SUMS == sums + 3
    assert not plain
    assert int(got[0].valid.sum()) > 0


# ------------------------------------------- hypotheses: H1, H2 and H3 --


def _hyp_face_set(rng, F, n):
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals *= rng.uniform(0.97, 1.0, (n, 1))
    pad = F - n
    return dict(
        centroid=np.concatenate([rng.uniform(-8, 8, (n, 3)),
                                 np.zeros((pad, 3))]),
        normal=np.concatenate([normals, np.zeros((pad, 3))]),
        point_size=np.concatenate([rng.uniform(50, 4000, n), np.zeros(pad)]),
        voxel_count=np.concatenate([np.ones(n), np.zeros(pad)]),
        theta=np.concatenate([rng.uniform(0.2, 4.0, n), np.zeros(pad)]),
        valid=np.arange(F) < n)


def _hyp_faces(seed, P, F, kinds=(), dev="cpu"):
    """P pairs of face sets (f1, f2 = f1 rotated, translated and a little
    perturbed, so bases match); ``kinds[k]`` makes pair k an edge case:
    "none" (no valid face), "zero" (zero normals on valid faces), "nan" (a
    NaN normal, centroid and point size)."""
    from fccf_pcr_torch.features.faces import Faces

    rng = np.random.default_rng(seed)
    f1s, f2s = [], []
    for k in range(P):
        a = _hyp_face_set(rng, F, int(rng.integers(max(F - 4, 2), F + 1)))
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        th = np.deg2rad(rng.uniform(5, 40))
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        v = a["valid"][:, None]
        b = dict(a)
        b["normal"] = np.where(v, a["normal"] @ R.T + rng.normal(
            scale=0.002, size=(F, 3)), 0.0)
        b["centroid"] = np.where(v, a["centroid"] @ R.T + rng.normal(size=3),
                                 0.0)
        kind = kinds[k] if k < len(kinds) else "plain"
        if kind == "none":
            a["valid"] = np.zeros(F, bool)
        elif kind == "zero":
            a["normal"][1] = 0.0
            b["normal"][2] = 0.0
        elif kind == "nan":
            a["normal"][0] = np.nan
            b["centroid"][1] = np.nan
            a["point_size"][2] = np.nan
        f1s.append(a)
        f2s.append(b)

    def stack(fs):
        dtype = dict(voxel_count=np.int32, valid=bool)
        return Faces(**{k: torch.from_numpy(np.stack([f[k] for f in fs])
                                            .astype(dtype.get(k, np.float32)))
                        .to(dev) for k in Faces._fields})
    return stack(f1s), stack(f2s)


def _hyp_stage_equal(f1, f2, caps):
    """H1, H2 and H3 against their plain versions on the same CUDA inputs,
    each stage bit for bit (NaN-aware; H2's hits where kept, its other
    outputs whole; H3 also on H2's own slots), then generate_hypotheses
    (the kernels) against the plain chain. Returns the plain
    hypotheses."""
    from fccf_pcr_torch.hypotheses.transforms import Hypotheses
    from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    params = FCCFParams()
    pb1, pb2 = hk.bases_plain(f1, params), hk.bases_plain(f2, params)
    kb1, kb2 = hk._launch_bases(f1, params), hk._launch_bases(f2, params)
    assert _all_equal(kb1, pb1) and _all_equal(kb2, pb2)
    pm = hk.matches_plain(f1, f2, params, caps.max_matches)
    km = hk._launch_matches(f1, f2, params, caps.max_matches)
    assert _all_equal(km, pm)
    ps = hk.slots_plain(f1, f2, pm, params, caps.per_match_hits)
    ks = hk._launch_slots(f1, f2, pm, params, caps.per_match_hits)
    assert _all_equal(hk.kept_hits(ks), ps)
    pe = hk.emit_plain(ps, pm, caps.max_hypotheses)
    assert _all_equal(hk._launch_emit(ps, pm, caps.max_hypotheses), pe)
    assert _all_equal(hk._launch_emit(ks, km, caps.max_hypotheses), pe)
    got = generate_hypotheses(f1, f2, params, caps)
    assert _all_equal(got, pe)
    return Hypotheses(*pe)


def test_acos_matches_torch(cuda):
    """CUDA's acosf (the function H1 and H2 call) == torch.arccos on the
    card at every float32 in [-1, 1], and at random float32 of any
    magnitude, inf and NaN."""
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    step = 1 << 26
    one = int(np.array(1.0, np.float32).view(np.int32))
    for sign in (0, -(1 << 31)):
        for lo in range(0, one + 1, step):
            x = (torch.arange(lo, min(lo + step, one + 1), dtype=torch.int32,
                              device=cuda) + sign).view(torch.float32)
            assert torch.equal(_bits(hk.acos_probe(x)),
                               _bits(torch.arccos(x))), lo + sign
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(-2**31, 2**31 - 1, (1 << 24,), generator=g, device=cuda,
                      dtype=torch.int64).to(torch.int32).view(torch.float32)
    x[:4] = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0])
    assert torch.equal(_bits(hk.acos_probe(x)), _bits(torch.arccos(x)))


@pytest.mark.parametrize("F,per_match,kinds", [
    (16, 16, ()), (16, 48, ()), (5, 16, ()), (24, 16, ()), (24, 48, ()),
    (64, 16, ()), (16, 16, ("nan", "zero", "none", "plain")), (96, 16, ()),
])
def test_hypotheses_kernels_match_plain(cuda, F, per_match, kinds):
    """At F = 64 H1 keeps its rows' ballot words in shared memory (252
    rows of 63 words a rank); at F = 96 (4560 bases a cloud) they do not
    fit and its write pass takes the ballots again; H2 lists the faces of
    up to 4096 slots."""
    f1, f2 = _hyp_faces(F * 10 + per_match, 4, F, kinds, cuda)
    h = _hyp_stage_equal(f1, f2, TEST_CAPS.replace(per_match_hits=per_match))
    assert int(h.count.sum()) > 0


@pytest.mark.parametrize("over", [dict(max_matches=64),
                                  dict(max_hypotheses=256),
                                  dict(per_match_hits=2),
                                  dict(per_match_hits=1000)])
def test_hypotheses_kernels_overflow(cuda, over):
    """Each overflow (matches past M, hits past H, a row's hits past
    PER_MATCH) and PER_MATCH above F * F + 1."""
    f1, f2 = _hyp_faces(31, 3, 16, (), cuda)
    h = _hyp_stage_equal(f1, f2, TEST_CAPS.replace(**over))
    assert bool(h.overflow.all()) == (over != dict(per_match_hits=1000))


def test_hypotheses_kernels_edge_faces(cuda):
    """No valid face, every normal zero, a NaN in every field, and one
    face: each pair of the batch its own case."""
    f1, f2 = _hyp_faces(41, 4, 16, ("none", "zero", "nan", "plain"), cuda)
    f1.normal[1].zero_()
    f2.normal[1].zero_()
    f1.valid[3, 1:] = False
    h = _hyp_stage_equal(f1, f2, TEST_CAPS)
    assert int(h.count[0]) == 0 and bool(torch.isnan(h.t[2]).any())


@pytest.mark.parametrize("runs", ["across", "cut", "one", "own"])
def test_hypotheses_slots_runs(cuda, runs):
    """H2 equals slots_plain (and H3 on its slots emit_plain) on matches
    whose runs of one source base cross H2's chunks, are cut by the
    count, hold every match or hold one match each: the matches phase 24
    of chip_smoke.py feeds H2 (``hyp_run_matches``)."""
    from chip_smoke import HYP_RUNS, hyp_run_matches
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    assert runs in HYP_RUNS
    f1, f2 = _hyp_faces(81, 2, 16, (), cuda)
    m = hyp_run_matches(runs, 16, 128, 2, cuda)
    for K in (16, 48):
        want = hk.slots_plain(f1, f2, m, FCCFParams(), K)
        got = hk._launch_slots(f1, f2, m, FCCFParams(), K)
        assert _all_equal(hk.kept_hits(got), want)
        assert _all_equal(hk._launch_emit(got, m, 2048),
                          hk.emit_plain(want, m, 2048))
    assert int(want.count.sum()) > 0


@pytest.mark.parametrize("what", [
    "--caps large", "escalated heritage", "M 1001", "H 0", "H 1",
    "H below the total", "H at the total", "H above the total", "no hit",
    "one match holds every hit", "a pair alone", "65535 pairs"])
def test_hypotheses_emit_cases(cuda, what):
    """H3 equals emit_plain bit for bit on phase 24's own H3 cases
    (chip_smoke.HYP_EMIT_CASES): the sizes of --caps large (M 4096, H
    16384) and of the heritage preset escalated (M 4096, H 6144, PER_MATCH
    96), M 1001, H 0 and 1, H below, at and above the total, no hit, one
    match holding every hit, a pair alone and 65535 pairs."""
    from chip_smoke import HYP_EMIT_CASES, hyp_emit_case
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    (case,) = [c for c in HYP_EMIT_CASES if c[0] == what]
    s, m, H = hyp_emit_case(case, cuda)
    assert _all_equal(hk._launch_emit(s, m, H), hk.emit_plain(s, m, H))


def test_hypotheses_lane_alone_equals_batch(cuda):
    from fccf_pcr_torch.features.faces import Faces
    from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses

    caps = TEST_CAPS.replace(max_matches=2048, max_hypotheses=3072,
                             per_match_hits=48)
    f1, f2 = _hyp_faces(51, 8, 16, ("plain", "nan", "zero"), cuda)
    batch = generate_hypotheses(f1, f2, FCCFParams(), caps)
    for k in (0, 1, 2, 7):
        alone = generate_hypotheses(Faces(*(x[k:k + 1] for x in f1)),
                                    Faces(*(x[k:k + 1] for x in f2)),
                                    FCCFParams(), caps)
        assert _all_equal([a[0] for a in alone], [b[k] for b in batch])


def test_hypotheses_kernels_in_a_capture(cuda):
    """The stage captured in a CUDA graph (twice), replayed twice: every
    replay equals the eager calls and H1-H3 count at each replay."""
    from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    f1, f2 = _hyp_faces(61, 4, 16, ("nan",), cuda)

    def fn(*a):
        F1, F2 = type(f1)(*a[:6]), type(f2)(*a[6:])
        return (tuple(generate_hypotheses(F1, F2, FCCFParams(), TEST_CAPS))
                + tuple(generate_hypotheses(F2, F1, FCCFParams(), TEST_CAPS)))

    args = tuple(f1) + tuple(f2)
    want = fn(*args)
    graphs = graph.Graphs(max_graphs=1)
    graphs.replay(fn, args)  # the capture
    counts = (hk.MATCHES, hk.SLOTS, hk.EMITS)
    for _ in range(2):
        got = graphs.replay(fn, args)
        torch.cuda.synchronize()
        assert _all_equal(got, want)
    assert (hk.MATCHES, hk.SLOTS, hk.EMITS) == tuple(c + 4 for c in counts)
    graphs.clear()


def test_hypotheses_kernels_reject_bad_inputs(cuda):
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    f1, f2 = _hyp_faces(71, 2, 16, (), cuda)
    params = FCCFParams()
    with pytest.raises(ValueError):
        hk.matches(f1._replace(normal=f1.normal.double()), f2, params, 64)
    with pytest.raises(ValueError):
        hk.matches(f1, f2._replace(valid=f2.valid[:, :8]), params, 64)
    with pytest.raises(ValueError):
        hk.matches(f1, f2._replace(theta=f2.theta.cpu()), params, 64)
    m = hk.matches(f1, f2, params, 64)
    with pytest.raises(ValueError):
        hk.slots(f1, f2, m._replace(i1=m.i1.int()), params, 16)
    s = hk.slots(f1, f2, m, params, 16)
    with pytest.raises(ValueError):
        hk.emit(s._replace(count=s.count.long()), m, 128)
    with pytest.raises(ValueError):
        hk.acos_probe(f1.theta.cpu())


def test_register_pair_launches_h1_h3_and_no_sort(cuda):
    """register_pair on the card launches H1, H2 and H3 once each a step
    (the step graph's replay), and the stage (the eager step) runs no
    torch.sort and no plain version."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from fccf_pcr_torch import register_pair
    from fccf_pcr_torch.ops import hypotheses_kernels as hk
    from fccf_pcr_torch.pipeline import register

    params = FCCFParams(leaf_size=0.25)
    src, tar, _ = synthetic.make_pair(seed=3, points_per_plane=1500,
                                      clutter_points=900)
    sp, sm = synthetic.pad_points(src, TEST_CAPS.max_points)
    tp, tm = synthetic.pad_points(tar, TEST_CAPS.max_points)
    register_pair(sp, sm, tp, tm, params, TEST_CAPS)  # warm: the capture
    torch.cuda.synchronize()
    counts = (hk.MATCHES, hk.SLOTS, hk.EMITS, hk.BASES)
    res = register_pair(sp, sm, tp, tm, params, TEST_CAPS)
    torch.cuda.synchronize()
    assert (hk.MATCHES, hk.SLOTS, hk.EMITS, hk.BASES) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3])
    assert int(res.n_hypotheses) > 0

    inside, sorts = [False], []
    real = register.generate_hypotheses

    def stage(*a):
        inside[0] = True
        try:
            return real(*a)
        finally:
            inside[0] = False

    class Sorts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if inside[0] and "sort" in str(func):
                sorts.append(str(func))
            return func(*args, **(kwargs or {}))

    def refused(*a):
        raise AssertionError("a plain version ran on the card")

    args = [torch.from_numpy(x)[None].to(cuda) for x in (sp, sm, tp, tm)]
    kept = (hk.matches_plain, hk.slots_plain, hk.emit_plain, hk.bases_plain)
    (hk.matches_plain, hk.slots_plain, hk.emit_plain,
     hk.bases_plain) = (refused,) * 4
    register.generate_hypotheses = stage
    try:
        with Sorts():
            register._register_batch(*args, params, TEST_CAPS)
        torch.cuda.synchronize()
    finally:
        register.generate_hypotheses = real
        (hk.matches_plain, hk.slots_plain, hk.emit_plain,
         hk.bases_plain) = kept
    assert not sorts


# ------------------------------------------------- fine verify: the join --


def _fine_case_on(name, dev):
    """test_torch_fine_kernels.fine_case's tensors on ``dev``."""
    from test_torch_fine_kernels import fine_case

    T, table, pts, mask = fine_case(name)
    return (T.to(dev), type(table)(*(x.to(dev) for x in table)), pts.to(dev),
            mask.to(dev))


def _fine_equal(name, T, table, pts, mask):
    """The join against its plain version on the same CUDA inputs, bit for
    bit, in the cluster size the wrapper picks, which is the case's
    (``FINE_CLUSTERS``, else 1 block). Returns the scores."""
    from fccf_pcr_torch.ops import fine_kernels as fk
    from test_torch_fine_kernels import FINE_CLUSTERS

    params = FCCFParams()
    want = fk.join_plain(T, table, pts, mask, params)
    Vf, M = table.keys.shape[-1], mask.shape[-1]
    assert fk.cluster_size(fk.build(), Vf, M) == FINE_CLUSTERS.get(name, 1)
    launches = fk.JOINS
    assert _all_equal([fk.join(T, table, pts, mask, params)], [want]), name
    torch.cuda.synchronize()
    assert fk.JOINS == launches + 1
    return want


def test_fine_kernels_match_plain(cuda):
    """Every case of tests/test_torch_fine_kernels.py's FINE_CASES: an empty
    table and target, every point outside the window, an overflowing and an
    aliased table, NaN and huge translations, one live run, one cell, odd
    and even n, Vf = 1, the main path's 8 pairs of 12, a hit count past
    65535; in clusters of 2 (default caps), 4 (40000 slots), 8 (an
    escalation of auto caps) and in the scratch (``--caps large``, and
    270000 points, four levels of fold_sum above a dense level longer than
    the shared one)."""
    from test_torch_fine_kernels import FINE_CASES

    for name in FINE_CASES:
        score = _fine_equal(name, *_fine_case_on(name, cuda))
        assert bool(torch.isfinite(score).all()), name


def test_fine_verify_pair_alone_equals_batch(cuda):
    from fccf_pcr_torch.verify.fine import fine_verify

    T, table, pts, mask = _fine_case_on("eight pairs", cuda)
    params = FCCFParams()
    batch = fine_verify(T, table, pts, mask, params, TEST_CAPS)
    for k in range(8):
        alone = fine_verify(T[k:k + 1], type(table)(*(x[k:k + 1]
                                                      for x in table)),
                            pts[k:k + 1], mask[k:k + 1], params, TEST_CAPS)
        assert _all_equal([a[0] for a in alone], [b[k] for b in batch])
    assert bool((batch[0] > 0).any())


def test_fine_kernels_in_a_capture(cuda):
    """fine_verify called twice in a captured CUDA graph, replayed twice:
    every replay equals the eager calls and the join counts at each
    replay."""
    from fccf_pcr_torch.ops import fine_kernels as fk
    from fccf_pcr_torch.verify.fine import fine_verify

    T, table, pts, mask = _fine_case_on("NaN and huge T", cuda)
    n = len(table)

    def fn(T, pts, mask, *tab):
        tab = type(table)(*tab)
        return (fine_verify(T, tab, pts, mask, FCCFParams(), TEST_CAPS)
                + fine_verify(T[:, :3], tab, pts, mask, FCCFParams(),
                              TEST_CAPS))

    args = (T, pts, mask) + tuple(table)
    assert len(args) == 3 + n
    want = fn(*args)
    graphs = graph.Graphs(max_graphs=1)
    graphs.replay(fn, args)  # the capture
    counts = fk.JOINS
    for _ in range(2):
        got = graphs.replay(fn, args)
        torch.cuda.synchronize()
        assert _all_equal(got, want)
    assert fk.JOINS == counts + 4
    graphs.clear()


def test_fine_kernels_reject_bad_inputs(cuda):
    from fccf_pcr_torch.ops import fine_kernels as fk

    T, table, pts, mask = _fine_case_on("plain", cuda)
    params = FCCFParams()
    with pytest.raises(ValueError):
        fk.join(T.double(), table, pts, mask, params)
    with pytest.raises(ValueError):
        fk.join(T, table._replace(keys=table.keys.int()), pts, mask, params)
    with pytest.raises(ValueError):
        fk.join(T, table, pts.cpu(), mask, params)
    with pytest.raises(ValueError):
        fk.join(T, table._replace(counts=table.counts[..., :-1]), pts, mask,
                params)
    with pytest.raises(ValueError):  # 2^24 points
        fk.join(T, table, pts.new_zeros(2, 1 << 24, 3),
                mask.new_zeros(2, 1 << 24), params)
    lib = fk.build()
    assert lib.fccf_fine_join_shared(512, 500, 3) == -1  # no cluster of 3
    assert lib.fccf_fine_join_shared(40000, 100000, 1) == -1
    assert lib.fccf_fine_join_shared(65536, 0, 8) == -1  # past 16 bits
    assert lib.fccf_fine_join_scratch(65536, 131072) > 0


def test_register_pair_launches_v1_v2_and_no_plain_fine(cuda):
    """register_pair on the card launches the join once a step (the step
    graph's replay); the eager step runs neither plain version."""
    from fccf_pcr_torch import register_pair
    from fccf_pcr_torch.ops import fine_kernels as fk
    from fccf_pcr_torch.pipeline import register

    params = FCCFParams(leaf_size=0.25)
    src, tar, _ = synthetic.make_pair(seed=3, points_per_plane=1500,
                                      clutter_points=900)
    sp, sm = synthetic.pad_points(src, TEST_CAPS.max_points)
    tp, tm = synthetic.pad_points(tar, TEST_CAPS.max_points)
    register_pair(sp, sm, tp, tm, params, TEST_CAPS)  # warm: the capture
    torch.cuda.synchronize()
    counts = fk.JOINS
    res = register_pair(sp, sm, tp, tm, params, TEST_CAPS)
    torch.cuda.synchronize()
    assert fk.JOINS == counts + 1
    assert bool((res.fine_score > 0).any())

    def refused(*a):
        raise AssertionError("a plain version ran on the card")

    args = [torch.from_numpy(x)[None].to(cuda) for x in (sp, sm, tp, tm)]
    kept = (fk.lookup_plain, fk.score_plain)
    fk.lookup_plain, fk.score_plain = refused, refused
    try:
        register._register_batch(*args, params, TEST_CAPS)
        torch.cuda.synchronize()
    finally:
        fk.lookup_plain, fk.score_plain = kept
