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
face-membership diff on the card against the CPU, and the non-fused face
path on the card against the CPU.

This file imports no jax, so it runs on a machine without it (the
repository's conftest.py imports jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every test skips where torch.cuda.is_available() is false. Tolerances:
labels, status, face and hypothesis counts and kept masks exact; the
transform within the golden band (0.1 deg / 0.02 m); scores rtol 1e-3
(float32 reductions run in another order on the card)."""

import numpy as np
import pytest
import torch

from fccf_pcr_torch import TEST_CAPS, FCCFParams, make_register_fn
from fccf_pcr_torch import registration_errors
from fccf_pcr_torch.io import synthetic
from fccf_pcr_torch.ops import gather as gt
from fccf_pcr_torch.ops import label_prop as lp

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
    """A batched step waits for the card at most refine_iters + 30 times,
    whatever the batch size: the LM loop's all-done test once an
    iteration for every lane of the batch, the cluster scan's block count
    and fixpoint tests, the floor walk's two transfers and the inputs'
    copies; label propagation none. Counted under CUDA's sync debug
    mode, which warns at each synchronizing call."""
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
    assert 0 < counts[0] and max(counts) <= params.refine_iters + 30, counts


def test_mesh_split_on_one_card_is_bitwise_equal(cuda):
    """A batch of 4 split over [cuda:0] * 2 (one card standing in for
    two) against the unsplit batch: every field bitwise equal."""
    from fccf_pcr_torch.parallel.mesh import make_mesh, make_sharded_register_fn

    caps = TEST_CAPS
    params = FCCFParams(leaf_size=0.25)
    batch = [np.concatenate([a, a[:1]]) for a in _batch(caps)]
    whole = make_register_fn(params, caps, batched=True, device=cuda)(*batch)
    before = lp.PROPAGATIONS
    split = make_sharded_register_fn(params, caps,
                                     make_mesh(["cuda:0"] * 2))(*batch)
    assert lp.PROPAGATIONS == before + 4  # two passes a chunk
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
