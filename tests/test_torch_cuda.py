"""The port on a CUDA card: the label-prop kernel against its plain
version, and the main path on the card against the port on the CPU.

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
    before = lp.LAUNCHES
    got = lp.label_propagate(
        normal.to(cuda), centroid.to(cuda), valid.to(cuda), angle, l, k,
        bound=torch.tensor(bounds, dtype=torch.int32, device=cuda),
    )
    torch.cuda.synchronize()
    assert lp.LAUNCHES > before
    plain_gpu = lp.label_propagate_plain(
        normal.to(cuda), centroid.to(cuda), valid.to(cuda), angle, l, k
    )
    plain_cpu = lp.label_propagate(normal, centroid, valid, angle, l, k)
    np.testing.assert_array_equal(got.cpu().numpy(), plain_gpu.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), plain_cpu.numpy())


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
