"""The plain versions of the port's scans (fccf_pcr_torch/ops/scan.py: S1's
integer scans and S2's blocked prefix sum, the CPU's path) against the JAX
package's scans on the same seeded numpy inputs: cumsum against
jnp.cumsum, the running max against lax.cummax, the reversed running min
against lax.cummin(..., reverse=True), and prefix_sum against
jnp.cumsum(axis=0) on XLA's CPU (vmapped over batch rows), at row lengths
1 to 65536, with batch dims, sentinel tails, all-false and all-true flag
rows, and -0.0, inf and NaN in the float input.

Tolerances: none. The integer scans are exact (JAX computes in int32, so
the values stay inside int32); the prefix sums are compared bit for bit,
signed zeros included (every NaN counts as one value). The kernels
themselves run only on a card: tests/test_torch_cuda.py holds them to
these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fccf_pcr_torch.ops import scan
from fccf_pcr_torch.ops import voxelize as tvox

LENGTHS = (1, 15, 16, 17, 255, 256, 257, 4097, 65536)

_JAX = {
    "cumsum": jax.jit(lambda x: jnp.cumsum(x, axis=-1)),
    "cummax": jax.jit(lambda x: lax.cummax(x, axis=x.ndim - 1)),
    "rev_cummin": jax.jit(
        lambda x: lax.cummin(x, axis=x.ndim - 1, reverse=True)),
}
_PREFIX = jax.jit(jax.vmap(lambda v: jnp.cumsum(v, axis=0)))


def _int_rows(n, seed):
    """(2, 4, n) int32 rows as the step's scans see them: 0/1 flags (one
    row all false, one all true), a forward-filled index marker, an index
    row with a sentinel tail, and signed values."""
    rng = np.random.default_rng(seed)
    flags = rng.uniform(size=(4, n)) < 0.3
    flags[1] = False
    flags[2] = True
    idx = np.arange(n, dtype=np.int32)
    marked = np.where(rng.uniform(size=n) < 0.2, idx, 0)
    tail = np.where(idx < n - n // 3, idx, n).astype(np.int32)
    tail[rng.uniform(size=n) < 0.5] = n  # run starts, the rest the sentinel
    signed = rng.integers(-50_000, 50_000, n, dtype=np.int32)
    values = np.stack([marked, tail, signed, idx[::-1].copy()])
    return np.stack([flags.astype(np.int32), values.astype(np.int32)])


def _bits(a):
    a = np.asarray(a, np.float32)
    b = a.view(np.uint32).copy()
    b[np.isnan(a)] = 0x7FC00000
    return b


@pytest.mark.parametrize("n", LENGTHS)
def test_int_scans_match_jax(n):
    x = _int_rows(n, n)
    flags = torch.from_numpy(x[0] != 0)
    # Sums that stay inside int32, as JAX computes them.
    small = torch.from_numpy(np.clip(x, -3000, 3000))
    for name, fn, inputs in (
            ("cumsum", scan.cumsum,
             (flags, torch.from_numpy(x[0]), small, small.long())),
            ("cummax", scan.cummax,
             (torch.from_numpy(x), torch.from_numpy(x).long())),
            ("rev_cummin", scan.rev_cummin,
             (torch.from_numpy(x), torch.from_numpy(x).long()))):
        for t in inputs:
            want = np.asarray(_JAX[name](t.numpy().astype(np.int32)))
            got = fn(t)
            assert got.dtype == (torch.int64 if name == "cumsum" else t.dtype)
            assert got.shape == t.shape
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_int_scans_of_sliced_rows():
    """A view of each row's head (faces.py scans marker[..., :N]) scans
    as the same rows made contiguous."""
    x = torch.from_numpy(_int_rows(300, 3)).long()
    head = x[..., :257]
    for fn in (scan.cumsum, scan.cummax, scan.rev_cummin):
        assert torch.equal(fn(head), fn(head.contiguous()))


@pytest.mark.parametrize("n", LENGTHS)
def test_prefix_sum_matches_jax_bitwise(n):
    rng = np.random.default_rng(100 + n)
    x = rng.uniform(-1, 1, (3, n, 6)).astype(np.float32)
    x[..., 2] = -0.0
    x[0, :, 3] = np.where(rng.uniform(size=n) < 0.5, -0.0, 0.0)
    x[1, rng.uniform(size=n) < 0.01, 4] = np.nan
    x[2, rng.uniform(size=n) < 0.01, 0] = np.inf
    x[2, rng.uniform(size=n) < 0.01, 5] = -np.inf
    want = _bits(_PREFIX(x))
    np.testing.assert_array_equal(
        _bits(scan.prefix_sum(torch.from_numpy(x), dim=1).numpy()), want)
    # Along dim 0 of one cloud (tvox re-exports it) and along dim -2.
    np.testing.assert_array_equal(
        _bits(tvox.prefix_sum(torch.from_numpy(x[1])).numpy()), want[1])
    np.testing.assert_array_equal(
        _bits(scan.prefix_sum(torch.from_numpy(x), dim=-2).numpy()), want)


def test_prefix_sum_keeps_a_single_entry():
    """A scan of one entry returns it (-0.0 stays -0.0, as XLA's); of two
    or more, sums start from +0.0 (-0.0 + 0.0 is +0.0)."""
    for n in (1, 2, 17):
        x = np.full((n, 1), -0.0, np.float32)
        want = _bits(_PREFIX(x[None]))[0]
        got = _bits(scan.prefix_sum(torch.from_numpy(x)).numpy())
        np.testing.assert_array_equal(got, want)
        assert (got[0, 0] == 0x80000000) == (n == 1)


def test_scans_refuse_other_devices():
    for fn in (scan.cumsum, scan.cummax, scan.rev_cummin, scan.prefix_sum):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros(4, dtype=torch.int64, device="meta"))
