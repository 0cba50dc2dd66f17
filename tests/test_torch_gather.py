"""P1, the per-row gather (ops/gather.py): the plain version against numpy
at the TPU probe's own inputs (tools/probe_gather.py), the clamp, the
device dispatch, and label-prop's pointer jump through it against the
JAX package's pointer_jump. Integers: equal, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fccf_pcr_tpu.features.faces import pointer_jump as jpointer_jump
from fccf_pcr_torch.ops import gather as tg
from fccf_pcr_torch.ops import label_prop as tlp


def _probe_inputs():
    """tools/probe_gather.py's inputs: tbl = arange(1024) * 7 and 1024
    random indices, int32 (1, 1024)."""
    N = 1024
    tbl = (np.arange(N, dtype=np.int32) * 7).reshape(1, N)
    idx = np.random.default_rng(0).integers(0, N, N).astype(np.int32).reshape(1, N)
    return tbl, idx


def test_plain_matches_numpy_at_probe_inputs():
    tbl, idx = _probe_inputs()
    got = tg.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), tbl[0][idx[0]][None])


def test_rows_and_clamp():
    """Each row reads its own table; indices outside [0, V) clamp."""
    rng = np.random.default_rng(1)
    tbl = rng.integers(-50, 50, (4, 37)).astype(np.int32)
    idx = rng.integers(-10, 60, (4, 37)).astype(np.int32)
    got = tg.gather_rows_plain(torch.from_numpy(tbl), torch.from_numpy(idx))
    want = np.take_along_axis(tbl, np.clip(idx, 0, 36), axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_never_launches_the_kernel():
    tbl, idx = _probe_inputs()
    before = tg.LAUNCHES
    tg.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx))
    assert tg.LAUNCHES == before == 0


def test_other_devices_raise():
    tbl, idx = _probe_inputs()
    with pytest.raises(ValueError):
        tg.gather_rows(torch.from_numpy(tbl).to("meta"),
                       torch.from_numpy(idx).to("meta"))


@pytest.mark.parametrize("rounds", [1, 8])
def test_pointer_jump_matches_jax(rounds):
    """Path halving over label chains with invalid (2^30) slots, batched
    over 3 rows, against the JAX package's pointer_jump per row."""
    rng = np.random.default_rng(rounds)
    V = 300
    labels = np.empty((3, V), np.int32)
    for b in range(3):
        # each label points at or below its own index: chains toward roots
        labels[b] = (np.arange(V) * rng.uniform(0, 1, V)).astype(np.int32)
        labels[b][rng.uniform(size=V) < 0.1] = 2**30
    got = tlp.pointer_jump(torch.from_numpy(labels), V, rounds)
    for b in range(3):
        want = np.asarray(jpointer_jump(jnp.asarray(labels[b]), V, rounds))
        np.testing.assert_array_equal(got[b].numpy(), want)

