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
signed zeros included (every NaN counts as one value). The fused
entries (leaf_prefix_sums, moment_prefix_sums: the voxelization's leaf
and moment columns formed from their sources) are held the same way to
jnp.cumsum of the JAX package's own jnp.concatenate of those columns,
with -0.0, inf and NaN sources and masked rows (where x * 0.0 gives -0.0
or NaN), and downsample_and_voxelize to its bits with the columns
concatenated first, as before the fused entries. The kernels themselves
run only on a card: tests/test_torch_cuda.py holds them to these plain
versions."""

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


FUSED_LENGTHS = (1, 17, 257, 4097)


def _sources(n, seed):
    """Sources of the fused prefix sums, (2, n) rows: coordinates with
    -0.0, inf and NaN, some of them in masked rows; mask and first flags
    (rows of all-false and all-true masks beside random ones)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (2, n, 3)).astype(np.float32)
    p[rng.uniform(size=(2, n, 3)) < 0.1] = -0.0
    p[rng.uniform(size=(2, n, 3)) < 0.02] = np.inf
    p[rng.uniform(size=(2, n, 3)) < 0.02] = -np.inf
    p[rng.uniform(size=(2, n, 3)) < 0.02] = np.nan
    mask = rng.uniform(size=(2, n)) < 0.7
    mask[1, : n // 2] = False
    mask[1, n // 2:] = True
    first = rng.uniform(size=(2, n)) < 0.3
    first[:, 0] = True
    return p, mask, first


@jax.jit
def _jax_leaf(px, py, pz, m_s, face_first):
    """ps1 as fccf_pcr_tpu/ops/voxelize.py composes it, vmapped."""
    def one(px, py, pz, m_s, face_first):
        pts_s = jnp.stack([px, py, pz], axis=-1)
        w = m_s.astype(jnp.float32)
        ff = (face_first & m_s).astype(jnp.float32)
        vals1 = jnp.concatenate([pts_s * w[:, None], ff[:, None]], axis=-1)
        return jnp.cumsum(vals1, axis=0)
    return jax.vmap(one)(px, py, pz, m_s, face_first)


@jax.jit
def _jax_moments(p, down_mask):
    """ps2 as fccf_pcr_tpu/ops/voxelize.py composes it, vmapped."""
    def one(p, down_mask):
        outer6 = jnp.stack(
            [p[:, 0] * p[:, 0], p[:, 1] * p[:, 1], p[:, 2] * p[:, 2],
             p[:, 0] * p[:, 1], p[:, 0] * p[:, 2], p[:, 1] * p[:, 2]],
            axis=-1)
        vals2 = jnp.concatenate(
            [p, outer6, down_mask.astype(jnp.float32)[:, None]], axis=-1)
        return jnp.cumsum(vals2, axis=0)
    return jax.vmap(one)(p, down_mask)


@pytest.mark.parametrize("n", FUSED_LENGTHS)
def test_leaf_prefix_sums_match_jax_bitwise(n):
    p, mask, first = _sources(n, 200 + n)
    want = _bits(_jax_leaf(p[..., 0], p[..., 1], p[..., 2], mask, first))
    tp = torch.from_numpy(p)
    got = scan.leaf_prefix_sums(tp[..., 0], tp[..., 1], tp[..., 2],
                                torch.from_numpy(mask),
                                torch.from_numpy(first))
    assert got.shape == (2, n, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    # Masked rows keep x * 0.0: -0.0 for a negative or -0.0 coordinate
    # (its row's column starts a scan of -0.0 only at n = 1), NaN for an
    # infinite or NaN one.
    cols = scan.leaf_columns(tp[..., 0], tp[..., 1], tp[..., 2],
                             torch.from_numpy(mask), torch.from_numpy(first))
    off = ~mask[..., None] & (p < 0)
    assert np.all(_bits(cols[..., :3].numpy())[off & np.isfinite(p)]
                  == 0x80000000)
    assert np.isnan(cols[..., :3].numpy()[~mask[..., None]
                                         & ~np.isfinite(p)]).all()


@pytest.mark.parametrize("n", FUSED_LENGTHS)
def test_moment_prefix_sums_match_jax_bitwise(n):
    p, mask, _ = _sources(n, 300 + n)
    # down_anchored is zero off the mask; the sums must not depend on it.
    p[~mask] = np.where(np.arange(3) == 0, -0.0, 0.0)
    want = _bits(_jax_moments(p, mask))
    got = scan.moment_prefix_sums(torch.from_numpy(p), torch.from_numpy(mask))
    assert got.shape == (2, n, 10) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), want)


def test_fused_columns_are_the_concatenated_columns():
    """leaf_columns / moment_columns give the bits of the columns
    ops/voxelize.py concatenated before the fused entries (with its
    _outer6)."""
    p, mask, first = _sources(257, 7)
    tp, tm, tf = (torch.from_numpy(a) for a in (p, mask, first))
    w = tm.float()
    vals1 = torch.cat([tp * w[..., None], (tf & tm).float()[..., None]], -1)
    vals2 = torch.cat([tp, tvox._outer6(tp, tp), w[..., None]], -1)
    for got, want in ((scan.leaf_columns(tp[..., 0], tp[..., 1], tp[..., 2],
                                         tm, tf), vals1),
                      (scan.moment_columns(tp, tm), vals2)):
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(want.numpy()))


@pytest.mark.parametrize("wide_extent", [False, True],
                         ids=["office", "wide_extent"])
def test_voxelize_bits_unchanged_by_fused_sums(monkeypatch, wide_extent):
    """downsample_and_voxelize gives the same bits through the fused
    entries as with its columns concatenated and then prefix-summed (the
    call sites before the fused entries), at an office-like and a
    wide-extent (two-key) shape."""
    rng = np.random.default_rng(11 + wide_extent)
    cap, n = 6144, 5000
    extent = 60.0 if wide_extent else 12.0
    pts = np.zeros((2, cap, 3), np.float32)
    pts[:, :n] = rng.uniform(-extent / 2, extent / 2, (2, n, 3))
    mask = np.arange(cap) < n
    mask = np.stack([mask, np.arange(cap) < n - 700])
    args = (torch.from_numpy(pts), torch.from_numpy(mask), 0.25,
            2.0 if wide_extent else 0.5, 1536)

    def run():
        return tvox.downsample_and_voxelize(*args, wide_extent=wide_extent)

    new = run()
    monkeypatch.setattr(
        scan, "leaf_prefix_sums",
        lambda *a: scan.prefix_sum(scan.leaf_columns(*a), dim=-2))
    monkeypatch.setattr(
        scan, "moment_prefix_sums",
        lambda p, m: scan.prefix_sum(
            torch.cat([p, tvox._outer6(p, p), m.float()[..., None]], -1),
            dim=-2))
    old = run()
    flat_new = torch.utils._pytree.tree_leaves(new)
    flat_old = torch.utils._pytree.tree_leaves(old)
    assert len(flat_new) == len(flat_old) > 5
    for a, b in zip(flat_new, flat_old):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_fused_sums_refuse_other_devices():
    meta = torch.zeros((2, 4), dtype=torch.float32, device="meta")
    flag = torch.zeros((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        scan.leaf_prefix_sums(meta, meta, meta, flag, flag)
    with pytest.raises(ValueError, match="unsupported device"):
        scan.moment_prefix_sums(meta[..., None].expand(2, 4, 3), flag)
