"""The propagation's roofline count: the work its inputs need, the same
however many sweeps a propagation runs."""

import math

import torch

import _paths
from benchlib import propagate_work
from refpipe import label_prop


def voxels(seed, P=2, V=96):
    """Voxels on a few noisy planes, so components take several sweeps."""
    g = torch.Generator().manual_seed(seed)
    normal = torch.zeros(P, V, 3)
    normal[..., 2] = 1.0
    normal = normal + 0.03 * torch.randn(P, V, 3, generator=g)
    centroid = torch.rand(P, V, 3, generator=g) * 10.0
    centroid[..., 2] = 0.02 * torch.randn(P, V, generator=g)
    valid = torch.rand(P, V, generator=g) < 0.8
    return normal, centroid, valid


def sweeps_of(labels_by_cap):
    return next(i for i, x in enumerate(labels_by_cap)
                if torch.equal(x, labels_by_cap[-1])) + 1


def test_count_does_not_move_with_the_sweeps():
    normal, centroid, valid = voxels(3)
    args = (normal, centroid, valid, 5.0, 0.5, 5.0)
    labels = [label_prop.label_propagate_plain(*args, max_iters=s)
              for s in range(1, 12)]
    assert sweeps_of(labels) > 1  # the sweeps do change the labels
    assert not torch.equal(labels[0], labels[-1])
    counts = {propagate_work.work(normal, centroid, valid, 5.0)
              for _ in labels}
    assert len(counts) == 1
    # a count by the sweeps run (each sweep testing every pair again)
    # grows with them; the work count does not take them
    ops, _ = counts.pop()
    per_sweep = [s * ops for s in (1, sweeps_of(labels))]
    assert per_sweep[0] != per_sweep[1]


def test_count_by_hand():
    normal = torch.tensor([[[0.0, 0, 1], [0, 0, 1], [1, 0, 0], [0, 0, 1]]])
    centroid = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 0]]])
    valid = torch.tensor([[True, True, True, False]])
    n, normal_tests, plane_tests = propagate_work.cloud_work(
        normal[0], centroid[0], valid[0], 5.0)
    assert (n, normal_tests, plane_tests) == (3, 3, 1)
    ops, nbytes = propagate_work.work(normal, centroid, valid, 5.0)
    assert ops == 3 * 9 + 3 * 6 + 1 * 29
    assert nbytes == 4 * (6 * 4 + 1 + 4)
    s, by = propagate_work.bound_s(ops, nbytes)
    assert by == "bytes" and math.isclose(s, nbytes / 3.35e12)
