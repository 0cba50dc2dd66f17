"""Label propagation (K1): the port's plain PyTorch version against the
JAX Pallas kernel in interpret mode and the JAX XLA path, and the CUDA
kernel against the plain version on the card.

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
    before = tlp.LAUNCHES
    got = tlp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0,
                              bound=bound)
    torch.cuda.synchronize()
    assert tlp.LAUNCHES > before
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
