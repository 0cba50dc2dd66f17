"""Label propagation (K1, P1): the port's plain PyTorch version against
the JAX Pallas kernel in interpret mode and the JAX XLA path, a numpy
model of the CUDA propagation kernel's schedule against the JAX XLA path,
and the CUDA kernel against the plain version on the card.

Labels are integers and must be EQUAL (no tolerance)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fccf_pcr_tpu.features.faces import _label_propagate, _pairwise_affinity
from fccf_pcr_tpu.ops.pallas.label_prop import label_propagate_pallas
from fccf_pcr_torch.ops import label_prop as tlp


def _clustered(seed, V, n_groups=6, prefix=None, keep=0.85):
    """Clustered normals/centroids (centroids in their group's plane), as
    in tests/test_pallas_label_prop.py."""
    rng = np.random.default_rng(seed)
    gn = rng.normal(size=(n_groups, 3))
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    gc = rng.uniform(-10, 10, (n_groups, 3))
    which = rng.integers(0, n_groups, V)
    normal = (gn[which] + rng.normal(0, 0.01, (V, 3))).astype(np.float32)
    offsets = rng.uniform(-4, 4, (V, 3)).astype(np.float32)
    offsets -= (offsets * gn[which]).sum(1, keepdims=True) * gn[which]
    centroid = (gc[which] + offsets).astype(np.float32)
    if prefix is None:
        valid = rng.uniform(size=V) < keep
    else:
        valid = np.arange(V) < prefix
    return normal, centroid, valid


def _jax_xla(normal, centroid, valid, angle=5.0, l=0.5, k=5.0):
    args = (jnp.asarray(normal), jnp.asarray(centroid), jnp.asarray(valid),
            angle, l, k)
    return np.asarray(_label_propagate(_pairwise_affinity(*args),
                                       jnp.asarray(valid), 64))


def _port(normal, centroid, valid, angle=5.0, l=0.5, k=5.0, **kw):
    return tlp.label_propagate(
        torch.from_numpy(normal), torch.from_numpy(centroid),
        torch.from_numpy(valid), angle, l, k, **kw,
    ).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret_and_xla(seed):
    normal, centroid, valid = _clustered(seed, 512)
    got = _port(normal, centroid, valid)
    np.testing.assert_array_equal(got, _jax_xla(normal, centroid, valid))
    pallas = np.asarray(label_propagate_pallas(
        jnp.asarray(normal), jnp.asarray(centroid), jnp.asarray(valid),
        5.0, 0.5, 5.0, sweeps_per_call=2, interpret=True,
    ))
    np.testing.assert_array_equal(got, pallas)
    assert len(np.unique(got[valid])) >= 2  # real components formed


@pytest.mark.parametrize("prefix", [1, 130, 512])
def test_bound_covering_valid_slots_changes_nothing(prefix):
    normal, centroid, valid = _clustered(7, 512, n_groups=5, prefix=prefix)
    want = np.asarray(label_propagate_pallas(
        jnp.asarray(normal), jnp.asarray(centroid), jnp.asarray(valid),
        5.0, 0.5, 5.0, sweeps_per_call=2, interpret=True,
        bound=jnp.int32(prefix),
    ))
    got = _port(normal, centroid, valid, bound=prefix)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_xla(normal, centroid, valid))


@pytest.mark.parametrize("schedule", [(2, 0), (1, 2), (4, 1)])
def test_schedule_invariance(schedule):
    """Any Pallas schedule reaches the port's labels: the fixpoint is
    exact and schedule-free."""
    sweeps, jumps = schedule
    normal, centroid, valid = _clustered(3, 512)
    want = np.asarray(label_propagate_pallas(
        jnp.asarray(normal), jnp.asarray(centroid), jnp.asarray(valid),
        5.0, 0.5, 5.0, sweeps_per_call=sweeps, jump_rounds=jumps,
        interpret=True,
    ))
    np.testing.assert_array_equal(_port(normal, centroid, valid), want)


def test_tail_batch_and_pass2_bound():
    """V not a multiple of any block size, a batch of 2 pairs, pass-2
    parameters with a small compacted bound."""
    pairs = [_clustered(11, 700), _clustered(12, 700, prefix=40)]
    normal = np.stack([p[0] for p in pairs])
    centroid = np.stack([p[1] for p in pairs])
    valid = np.stack([p[2] for p in pairs])
    got = tlp.label_propagate(
        torch.from_numpy(normal), torch.from_numpy(centroid),
        torch.from_numpy(valid), 8.0, 1.0, 2.0,
        bound=torch.tensor([700, 40], dtype=torch.int32),
    ).numpy()
    assert got.shape == (2, 700) and got.dtype == np.int32
    for b in range(2):
        want = _jax_xla(normal[b], centroid[b], valid[b], 8.0, 1.0, 2.0)
        np.testing.assert_array_equal(got[b], want)
        assert (got[b][~valid[b]] == 2**30).all()


def test_cpu_never_launches_the_kernel():
    before = tlp.LAUNCHES
    normal, centroid, valid = _clustered(5, 256)
    _port(normal, centroid, valid)
    assert tlp.LAUNCHES == before == 0
    assert tlp.PROPAGATIONS == 0


def test_other_devices_raise():
    normal, centroid, valid = _clustered(5, 64)
    with pytest.raises(ValueError):
        tlp.label_propagate(
            torch.from_numpy(normal).to("meta"),
            torch.from_numpy(centroid).to("meta"),
            torch.from_numpy(valid).to("meta"), 5.0, 0.5, 5.0,
        )


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1536, 1000])
def test_kernel_matches_plain_on_cuda(V):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    pairs = [_clustered(20 + V, V), _clustered(21 + V, V, prefix=97)]
    normal = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    centroid = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    valid = torch.from_numpy(np.stack([p[2] for p in pairs])).to(dev)
    bound = torch.tensor([V, 97], dtype=torch.int32, device=dev)
    before = tlp.PROPAGATIONS
    got = tlp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0,
                              bound=bound)
    torch.cuda.synchronize()
    assert tlp.PROPAGATIONS == before + 1
    want = tlp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("V", [1, 63, 700, 1000, 1536, 9216])
def test_sweep_grid_covers_the_square_once(V):
    """The kernel's (row tiles, j slices) grid covers [0, V)^2 exactly:
    every (i, j) in one tile, no tile past the edge, and enough tiles
    to give every SM of an H100 (132 SMs) several blocks at V >= 1536."""
    BI = tlp.BI
    BJ, rows, cols = tlp.sweep_grid(V, 132)
    assert BJ % 32 == 0 and 32 <= BJ <= 512
    cover = np.zeros((V, V), np.int32)
    for r in range(rows):
        for c in range(cols):
            assert r * BI < V and c * BJ < V  # no empty tile
            cover[r * BI:(r + 1) * BI, c * BJ:(c + 1) * BJ] += 1
    np.testing.assert_array_equal(cover, 1)
    if V >= 1536:
        assert rows * cols >= 8 * 132


# ------------------------------------------- the propagation kernel's schedule --


def _ring(seed, V=120):
    """Voxels on a circle of radius 10 at 3 deg steps, normals radial: only
    neighbours on the circle are affine (6 deg fails the 5 deg gate), so
    components are long chains (arcs between invalid slots). Slots are
    shuffled, so labels do not fall along a chain."""
    rng = np.random.default_rng(seed)
    a = np.deg2rad(3.0 * np.arange(V))
    order = rng.permutation(V)
    normal = np.stack([np.cos(a), np.sin(a), np.zeros(V)], 1)[order]
    centroid = 10.0 * normal
    valid = rng.uniform(size=V) < 0.95
    return normal.astype(np.float32), centroid.astype(np.float32), valid


def _kernel_schedule(affs, valids, rng, jump_rounds, sweep, max_iters=64):
    """numpy model of csrc/label_prop.cu's propagation kernel over a batch
    of pairs (``affs``, ``valids``: one (V, V) affinity and (V,) mask
    each): a sweep (Jacobi from the labels before it, or ``in_place``:
    rows in a random order, each reading the labels as the others leave
    them, as the atomicMin merges do) of every pair in the first sweep,
    then only of the pairs whose previous sweep lowered a label; stop once
    a sweep lowered nothing, else ``jump_rounds`` rounds of path halving
    in place over the pairs this sweep lowered, rows in a random order.
    Returns the labels of each pair, the sweeps run and, per pair, the
    sweeps that worked on it."""
    labs = [np.where(v, np.arange(v.shape[0]), _BIG_NP).astype(np.int64)
            for v in valids]
    active = [True] * len(labs)
    swept = [0] * len(labs)
    sweeps = 0
    while sweeps < max_iters:
        sweeps += 1
        lowered = [False] * len(labs)
        for p, (aff, valid, lab) in enumerate(zip(affs, valids, labs)):
            if not active[p]:
                continue
            swept[p] += 1
            if sweep == "jacobi":
                neigh = np.where(aff, lab[None, :], _BIG_NP).min(axis=1)
                lowered[p] = bool((neigh < lab).any())
                lab[:] = np.minimum(lab, neigh)
            else:
                for i in rng.permutation(lab.shape[0]):
                    m = lab[aff[i]].min(initial=_BIG_NP)
                    if valid[i] and m < lab[i]:
                        lab[i], lowered[p] = m, True
        if not any(lowered):
            break
        for p, lab in enumerate(labs):
            if not lowered[p]:
                continue
            V = lab.shape[0]
            for i in rng.permutation(V):
                if lab[i] >= _BIG_NP:
                    continue
                for _ in range(jump_rounds):
                    lab[i] = min(lab[i], lab[min(lab[i], V - 1)])
        active = lowered
    return labs, sweeps, swept


_BIG_NP = 2**30


@pytest.mark.parametrize("sweep", ["jacobi", "in_place"])
@pytest.mark.parametrize("jump_rounds", [0, 1, 2])
@pytest.mark.parametrize("graph", ["clustered", "ring"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_schedule_reaches_the_reference_fixpoint(seed, graph,
                                                        jump_rounds, sweep):
    """Any order of rows in the sweep and in the in-place halving, and any
    number of halving rounds, ends at the JAX package's labels
    (``_label_propagate(_pairwise_affinity(...))``) on random clustered
    graphs and on long chains."""
    if graph == "clustered":
        normal, centroid, valid = _clustered(40 + seed, 300)
    else:
        normal, centroid, valid = _ring(40 + seed)
    want = _jax_xla(normal, centroid, valid)
    aff = np.asarray(_pairwise_affinity(
        jnp.asarray(normal), jnp.asarray(centroid), jnp.asarray(valid),
        5.0, 0.5, 5.0))
    rng = np.random.default_rng(seed)
    (got,), sweeps, _ = _kernel_schedule([aff], [valid], rng, jump_rounds,
                                         sweep)
    np.testing.assert_array_equal(got, want)
    assert sweeps < 64
    if graph == "ring":  # chains: more than one component, more than one sweep
        assert len(np.unique(got[valid])) >= 2 and sweeps >= 3


@pytest.mark.parametrize("sweep", ["jacobi", "in_place"])
@pytest.mark.parametrize("jump_rounds", [0, 1])
def test_kernel_schedule_skips_pairs_at_their_fixpoint(jump_rounds, sweep):
    """A batch whose pairs converge at different sweeps (long chains, a
    clustered graph, no valid slot): after the first sweep the kernel
    sweeps and halves only the pairs whose previous sweep lowered a
    label, and every pair still ends at the JAX package's labels."""
    graphs = [_ring(50), _clustered(51, 120), _ring(52),
              (*_clustered(53, 120)[:2], np.zeros(120, bool))]
    affs = [np.asarray(_pairwise_affinity(
        jnp.asarray(n), jnp.asarray(c), jnp.asarray(v), 5.0, 0.5, 5.0))
        for n, c, v in graphs]
    rng = np.random.default_rng(jump_rounds)
    labs, sweeps, swept = _kernel_schedule(
        affs, [g[2] for g in graphs], rng, jump_rounds, sweep)
    for (n, c, v), got in zip(graphs, labs):
        np.testing.assert_array_equal(got, _jax_xla(n, c, v))
    assert swept[3] == 1 and swept[1] < max(swept[0], swept[2]) == sweeps
    assert len(set(swept)) >= 3  # pairs converge at different sweeps


@pytest.mark.parametrize("bound", [None, 40, "tensor"])
def test_kernel_inputs(bound):
    """The kernels' inputs, built on the CPU: field-major stats, one bound
    a pair, initial labels (slot index, 2^30 where invalid)."""
    normal, centroid, valid = _clustered(8, 100, prefix=60)
    P = 2
    n, c, v = (torch.from_numpy(np.stack([a, a])) for a in
               (normal, centroid, valid))
    if bound == "tensor":
        bound = torch.tensor(60)
    stats, bound_t, labels = tlp._kernel_inputs(n, c, v, bound)
    assert stats.shape == (P, 12, 100) and stats.is_contiguous()
    assert bound_t.dtype == torch.int32 and bound_t.shape == (P,)
    want_bound = {None: 100, 40: 40}.get(bound, 60)
    assert bound_t.tolist() == [want_bound] * P
    want = np.where(valid, np.arange(100), 2**30)
    assert labels.dtype == torch.int32 and labels.is_contiguous()
    np.testing.assert_array_equal(labels.numpy(), np.stack([want, want]))
    np.testing.assert_array_equal(stats[0, 11].numpy(), valid.astype(np.float32))


def test_propagation_kernel_refuses_cpu_tensors():
    normal, centroid, valid = _clustered(9, 64)
    stats, bound, labels = tlp._kernel_inputs(
        *(torch.from_numpy(a)[None] for a in (normal, centroid, valid)), None)
    flags = torch.zeros((4, 2), dtype=torch.int32)
    sweeps = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(ValueError):
        tlp._launch_propagate(stats, bound, labels, flags, sweeps, 0.99, 0.5,
                              5.0, 4)
    assert tlp.PROPAGATIONS == 0
