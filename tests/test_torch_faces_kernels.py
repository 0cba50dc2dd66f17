"""The plain versions of the faces stage's kernels (ops/faces_kernels.py:
F1, the plane fit with its gates and orientation; F2, the label segment
sums in the face-statistics and values forms) against the JAX package on
the CPU, from the same seeded NumPy inputs.

Tolerances as the existing tests': the plane fit, its gates and the
oriented normals exact (the port rounds as XLA compiles the reference on
the CPU; tests/test_torch_ops.py); face statistics rtol 1e-5 / atol 1e-5
and voxel counts exact (the doubling scan adds in another order than the
one-hot contraction; tests/test_torch_faces.py). A row of a batch of 4
equals that row alone bit for bit. The kernels themselves run only on a
card (tests/test_torch_cuda.py holds them to these plain versions)."""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fccf_pcr_tpu.features import faces as jfaces
from fccf_pcr_tpu.ops import eigen3 as jeig
from fccf_pcr_torch.ops import faces_kernels as fk

POINT_THRESHOLD = 5
CURVATURE_THRESHOLD = 0.04
_BIG = 2**30


def _covariances(rng, n):
    """Random planar and non-planar covariances, with zero, isotropic,
    rank-1 ones and -0.0 off-diagonals around a negative eigenvalue."""
    R = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    ev = rng.uniform(0.01, 1.0, (n, 3))
    ev[: n // 2, 0] = rng.uniform(1e-6, 1e-3, n // 2)
    cov = np.einsum("nij,nj,nkj->nik", R, ev, R).astype(np.float32)
    kinds = rng.integers(0, 8, n)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    cov[kinds == 0] = 0.0
    cov[kinds == 1] = np.eye(3, dtype=np.float32) * np.float32(0.5)
    for i in np.flatnonzero(kinds == 2):
        cov[i] = np.outer(u[i], u[i])
    for i in np.flatnonzero(kinds == 3):
        cov[i] = np.diag(rng.uniform(-1.0, 1.0, 3)).astype(np.float32)
        cov[i][~np.eye(3, dtype=bool)] = -0.0
    return cov


def plane_inputs(B, V, seed):
    """(cov, centroid, count, valid, global centroid) of B clouds of V
    voxels: counts around the threshold, invalid voxels."""
    rng = np.random.default_rng(seed)
    return (_covariances(rng, B * V).reshape(B, V, 3, 3),
            rng.uniform(-5, 5, (B, V, 3)).astype(np.float32),
            rng.integers(0, 12, (B, V)).astype(np.int32),
            rng.uniform(size=(B, V)) < 0.8,
            rng.uniform(-1, 1, (B, 3)).astype(np.float32))


def _jax_plane_fit(cov, centroid, count, valid, gcent):
    """The JAX package's plane fit, gates and orientation
    (fccf_pcr_tpu/features/faces.py:260-283)."""
    normal, curvature = jeig.plane_fit_from_cov(cov)
    enough = count > POINT_THRESHOLD
    planar = curvature < CURVATURE_THRESHOLD
    to_c = centroid - gcent[None, :]
    flip = jnp.sum(to_c * normal, axis=-1) < 0.0
    return (jnp.where(flip[:, None], normal, -normal), curvature,
            valid & enough & planar, valid & enough & ~planar)


def _plane_fit(*args):
    return fk.plane_fit(*args, POINT_THRESHOLD, CURVATURE_THRESHOLD)


@pytest.mark.parametrize("B,V", [(1, 1), (3, 257)])
def test_plane_fit_plain_matches_jax(B, V):
    args = plane_inputs(B, V, V)
    j = jax.jit(jax.vmap(_jax_plane_fit))(*(jnp.asarray(a) for a in args))
    t = _plane_fit(*(torch.from_numpy(a) for a in args))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def stat_inputs(B, V, seed, kind):
    """(labels, valid, count, centroid, normal): component-min labels
    ("random"), one-voxel faces ("singletons"), one face of every voxel
    ("one") or labels past V ("wide"); invalid rows labelled 2^30; counts
    of 0 in places, so negative coordinates give -0.0 columns."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(B, V)) < 0.8
    if kind == "random":
        labels = np.minimum(rng.integers(0, max(V // 7, 1), (B, V)),
                            np.arange(V))
    elif kind == "singletons":
        labels = np.broadcast_to(np.arange(V), (B, V)).copy()
    elif kind == "one":
        labels = np.zeros((B, V), np.int64)
        valid[:] = True
    else:
        labels = rng.integers(0, 2 * V, (B, V))
    labels = np.where(valid, labels, _BIG).astype(np.int64)
    centroid = rng.normal(size=(B, V, 3)).astype(np.float32) * 10.0
    normal = rng.normal(size=(B, V, 3)).astype(np.float32)
    for a in (centroid, normal):
        a[rng.uniform(size=a.shape) < 0.05] = -0.0
    return (labels, valid, rng.integers(0, 40, (B, V)).astype(np.int32),
            centroid, normal)


STAT_CASES = [(1, 1, "random"), (1, 1, "one"), (2, 300, "random"),
              (2, 300, "singletons"), (1, 257, "one"), (2, 300, "wide"),
              (1, 512, "random")]


@pytest.mark.parametrize("B,V,kind", STAT_CASES)
def test_face_stats_plain_matches_jax(B, V, kind):
    args = stat_inputs(B, V, B * V, kind)
    jfn = jax.jit(jax.vmap(functools.partial(jfaces._face_stats, V=V)))
    j = jfn(*(jnp.asarray(a) for a in args))
    t = fk.face_stats(*(torch.from_numpy(a) for a in args), V)
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


@pytest.mark.parametrize("B,V,kind", STAT_CASES)
def test_segment_sum_plain_matches_jax(B, V, kind):
    labels, valid, _, centroid, _ = stat_inputs(B, V, B + V, kind)
    values = np.abs(centroid[..., 0])
    jfn = jax.jit(jax.vmap(functools.partial(jfaces._label_segment_sum,
                                             V=V)))
    j = jfn(jnp.asarray(values), jnp.asarray(labels), jnp.asarray(valid))
    t = fk.label_segment_sum(torch.from_numpy(values),
                             torch.from_numpy(labels),
                             torch.from_numpy(valid), V)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def _assert_rows_alone(fn, args, n=4):
    """fn on a batch of n rows, each output row bit for bit fn of that
    row alone."""
    full = fn(*args)
    for k in range(n):
        alone = fn(*(a[k:k + 1] for a in args))
        for x, y in zip(full, alone):
            assert x.dtype == y.dtype and torch.equal(x[k:k + 1], y), k


def test_rows_sum_alike_alone_and_in_a_batch():
    _assert_rows_alone(_plane_fit, [torch.from_numpy(a)
                                    for a in plane_inputs(4, 300, 1)])
    for kind in ("random", "singletons"):
        labels, valid, count, centroid, normal = (
            torch.from_numpy(a) for a in stat_inputs(4, 300, 2, kind))
        _assert_rows_alone(lambda *a: fk.face_stats(*a, 300),
                           (labels, valid, count, centroid, normal))
        _assert_rows_alone(
            lambda v, lab, val: (fk.label_segment_sum(v, lab, val, 300),),
            (centroid[..., 0], labels, valid))


def test_segment_sum_keeps_the_scans_signed_zeros():
    """The sums are the doubling scan's: its +0.0 adds turn a -0.0 into
    +0.0 on every row they reach, so only a label whose one row is the
    first of the sorted rows keeps -0.0; slots without a row are +0.0
    and rows labelled past the slots are dropped."""
    V = 5
    values = torch.full((1, V), -0.0)
    labels = torch.tensor([[0, 1, 1, 3, 9]])
    valid = torch.tensor([[True, True, True, True, False]])
    got = fk.label_segment_sum(values, labels, valid, V)
    assert torch.equal(got, torch.zeros(1, V))
    assert torch.signbit(got).tolist() == [[True, False, False, False,
                                            False]]


def test_cpu_calls_build_nothing_and_other_devices_raise():
    args = [torch.from_numpy(a) for a in plane_inputs(1, 8, 3)]
    kept = fk._LIBRARY._lib, fk.PLANE_FITS, fk.SEGMENT_SUMS
    _plane_fit(*args)
    fk.face_stats(*(torch.from_numpy(a) for a in stat_inputs(1, 8, 3,
                                                             "random")), 8)
    assert (fk._LIBRARY._lib, fk.PLANE_FITS, fk.SEGMENT_SUMS) == kept
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        _plane_fit(*meta)


# PR 15's CPU outputs of face_stats and label_segment_sum on
# ``_digest_inputs`` (sha256 of their bytes, first 16 hex digits): the CPU
# path keeps its bits now that F2 takes the labels on the card.
PR15_DIGESTS = {(2, 300, "random"): ("f5c1d27c135044d1", "0b1777fff0439d1b"),
                (3, 1000, "wide"): ("2243396e9129e8f4", "21d4b55a017e08e0"),
                (1, 257, "singletons"): ("1bcd549027971124",
                                         "0fb2cf0c95a1192d")}


def _digest_inputs(B, V, seed, kind):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(B, V)) < 0.8
    if kind == "random":
        labels = np.minimum(rng.integers(0, max(V // 7, 1), (B, V)),
                            np.arange(V))
    elif kind == "wide":
        labels = rng.integers(0, 2 * V, (B, V))
    else:
        labels = np.broadcast_to(np.arange(V), (B, V)).copy()
    labels = np.where(valid, labels, _BIG).astype(np.int64)
    count = rng.integers(0, 40, (B, V)).astype(np.int32)
    centroid = rng.normal(size=(B, V, 3)).astype(np.float32)
    normal = rng.normal(size=(B, V, 3)).astype(np.float32)
    for a in (centroid, normal):
        a[rng.uniform(size=a.shape) < 0.05] = -0.0
    return [torch.from_numpy(a) for a in (labels, valid, count, centroid,
                                          normal)]


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("B,V,kind", sorted(PR15_DIGESTS))
def test_cpu_outputs_keep_pr15_bits(B, V, kind):
    labels, valid, count, centroid, normal = _digest_inputs(B, V, B * V,
                                                            kind)
    values = centroid[..., 0].contiguous()
    want = PR15_DIGESTS[(B, V, kind)]
    assert _digest(fk.face_stats(labels, valid, count, centroid, normal,
                                 V)) == want[0]
    assert _digest([fk.label_segment_sum(values, labels, valid, V)]) == want[1]


# ------------------------------------------- csrc/faces.cu's F2 in NumPy --


def _buckets(seg, V):
    """One cloud's keys (seg as int32, at least -2^31, sign flipped), their
    buckets (0 a negative seg, s + 1 slot s, V + 1 the invalid rows) and
    each bucket's first sorted row (V + 3 entries, the last n)."""
    key = (np.maximum(seg, -2**31) + 2**31).astype(np.uint32)
    bucket = np.where(seg < 0, 0, seg + 1)
    start = np.concatenate([[0], np.cumsum(np.bincount(bucket,
                                                       minlength=V + 2))])
    return key, bucket, start


def _block_slots(start, V, S):
    """(r, k_lo, k_hi) of each of a cloud's S blocks: from the bucket of
    the slot whose rows start at or after the r-th S-th of the slots' rows,
    so whole labels, balanced by rows."""
    first, rows = start[1], start[V + 1] - start[1]

    def bucket_at(pos):
        return int(np.searchsorted(start[1:V + 2], pos, side="left")) + 1

    for r in range(S):
        yield (r, 1 if r == 0 else bucket_at(first + rows * r // S),
               V + 1 if r == S - 1 else bucket_at(first + rows * (r + 1) // S))


def _range_order(key, bucket, lo, hi):
    """The rows of buckets [lo, hi) as a block orders them: in row order,
    then least-significant-digit passes over the 6-bit digits in which
    their keys differ."""
    rows = np.flatnonzero((bucket >= lo) & (bucket < hi))
    if len(rows):
        k = key[rows]
        diff = int(np.bitwise_or.reduce(k) ^ np.bitwise_and.reduce(k))
        for shift in range(0, 32, 6):
            if (diff >> shift) & 63:
                digit = (key[rows] >> np.uint32(shift)) & np.uint32(63)
                rows = rows[np.argsort(digit, kind="stable")]
    return rows


def _f2_order(seg, V, S):
    """F2's stable order of one cloud's seg (int64, n) over S blocks, as
    its order form writes it: each block its slots' rows, the first block
    also the negative segs, the last the invalid rows, each bucket's rows
    from its start. Returns (keys, order)."""
    key, bucket, start = _buckets(seg, V)
    order = np.full(len(seg), -1)
    for r, k_lo, k_hi in _block_slots(start, V, S):
        parts = [(k_lo, k_hi)] + [(0, 1)] * (r == 0) + [(V + 1, V + 2)] * (
            r == S - 1)
        for lo, hi in parts:
            order[start[lo]:start[hi]] = _range_order(key, bucket, lo, hi)
    assert np.all(order >= 0)
    return key, order


def _label_tree(rows, e):
    """One label's sum as F2 forms it: ``rows`` (L, D) float32, row m the
    label's m-th from its last, ``e`` the last row's sorted position. Node
    c of a level is row m = c * stride: at step dd * stride node c adds
    node c + dd where c = 0 mod 2 dd and that node is a row, +0.0 where it
    is not and e - m >= the step. The first level takes 128 rows (4 a
    lane: steps 1 to 64), the next ones 32 nodes (a warp's lanes); each
    group's total is a node of the next level."""
    L = len(rows)
    nodes = [r.copy() for r in rows]
    stride, group = 1, 128
    while True:
        for dd in [1 << k for k in range(group.bit_length() - 1)]:
            step = dd * stride
            for c in range(0, len(nodes), 2 * dd):
                m = c * stride
                if m + step <= L - 1:
                    nodes[c] = nodes[c] + nodes[c + dd]
                elif e - m >= step:
                    nodes[c] = nodes[c] + np.float32(0.0)
        nodes = nodes[::group]
        stride *= group
        group = 32
        if len(nodes) == 1:
            break
    x = nodes[0]
    return x + np.float32(0.0) if e >= stride else x


def _f2_emulation(labels, valid, cols, V, S):
    """F2's sums (B, V, D) and label lengths (B, V) of ``cols`` (B, n, D)
    float32, block by block as csrc/faces.cu splits a cloud over S blocks:
    bucket 0 holds the negative segs, bucket s + 1 slot s and bucket V + 1
    the invalid rows; their counts, scanned, give each bucket's first
    sorted row; block r takes the buckets of slots from the one that
    starts at or after row r / S of the slots' rows, so whole labels,
    balanced by rows, and the empty slots of the r-th S-th of the slots;
    every slot is written once."""
    B, n = labels.shape
    D = cols.shape[-1]
    sums = np.zeros((B, V, D), np.float32)
    lengths = np.zeros((B, V), np.int64)
    written = np.zeros((B, V), np.int64)
    for b in range(B):
        seg = np.where(valid[b], np.minimum(labels[b], V - 1), V)
        key, bucket, start = _buckets(seg, V)
        for r, k_lo, k_hi in _block_slots(start, V, S):
            order = _range_order(key, bucket, k_lo, k_hi)
            for slot in range(V * r // S, V * (r + 1) // S):
                if start[slot + 2] == start[slot + 1]:
                    written[b, slot] += 1
            for bk in range(k_lo, k_hi):
                s0, e = start[bk], start[bk + 1] - 1
                if e < s0:
                    continue
                rows_of = order[s0 - start[k_lo]:e + 1 - start[k_lo]]
                assert np.all(seg[rows_of] == bk - 1)
                sums[b, bk - 1] = _label_tree(cols[b, rows_of[::-1]], e)
                lengths[b, bk - 1] = e - s0 + 1
                written[b, bk - 1] += 1
    assert np.all(written == 1)
    return sums, lengths


def _f2_inputs(B, V, seed, kind):
    """Labels, valid flags and sources for the emulation: ``kind`` as
    ``stat_inputs``' kinds, or "negative" (labels below 0, some below
    -2^31), "past" (every valid row labelled V or above), "runs" (labels
    in sorted runs from the first rows, lengths 1-70: labels that start
    where no power of two lies between their length and their end keep a
    -0.0 sum); -0.0 and -NaN sources."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(B, V)) < 0.85
    if kind == "negative":
        labels = rng.integers(-V, V, (B, V))
        labels[:, ::13] -= 2**33
    elif kind == "past":
        labels = rng.integers(V, 3 * V, (B, V))
    elif kind == "runs":
        cuts = np.cumsum(rng.integers(1, 71, V))
        labels = np.broadcast_to(np.searchsorted(cuts, np.arange(V),
                                                 side="right"), (B, V)).copy()
        valid[:] = True
    else:
        labels, valid = stat_inputs(B, V, seed, kind)[:2]
        valid = valid.copy()
    labels = np.where(valid, labels, _BIG).astype(np.int64)
    count = rng.integers(0, 40, (B, V)).astype(np.int32)
    centroid = rng.normal(size=(B, V, 3)).astype(np.float32)
    normal = rng.normal(size=(B, V, 3)).astype(np.float32)
    for a in (centroid, normal):
        a[rng.uniform(size=a.shape) < 0.3] = -0.0
    values = centroid[..., 0].copy()
    values[..., 1::37] = -np.nan
    if kind == "runs":
        values[:] = -0.0
    return labels, valid, count, centroid, normal, values


F2_CASES = [(1, 1, "random", 1), (1, 1, "one", 1), (2, 37, "random", 3),
            (2, 300, "singletons", 8), (2, 300, "wide", 8),
            (1, 1200, "one", 8), (2, 700, "negative", 5), (1, 300, "past", 4),
            (1, 2100, "runs", 8), (1, 2100, "random", 2)]


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("B,V,kind,S", F2_CASES)
def test_f2_emulation_matches_plain(B, V, kind, S):
    """The order F2 forms equals torch.sort(stable=True) for labels of
    int32 range, and F2's trees, block by block, give the plain versions'
    bits: values (with -0.0 and -NaN) and face statistics."""
    labels, valid, count, centroid, normal, values = _f2_inputs(B, V, V + S,
                                                               kind)
    t = [torch.from_numpy(a) for a in (labels, valid, count, centroid,
                                       normal, values)]
    seg_s, order = fk.sorted_labels(t[0], t[1], V)
    for b in range(B):
        seg = seg_s.new_tensor(np.where(valid[b], np.minimum(labels[b], V - 1),
                                        V))
        key, got = _f2_order(seg.numpy(), V, S)
        if kind != "negative":
            np.testing.assert_array_equal(got, order[b].numpy())
        np.testing.assert_array_equal(np.sort(key), key[got])
    sums, _ = _f2_emulation(labels, valid, values[..., None], V, S)
    want = fk.values_sum_plain(seg_s, order, t[5], V).numpy()
    np.testing.assert_array_equal(_bits(sums[..., 0]), _bits(want))
    w = np.where(valid, count.astype(np.float32), np.float32(0.0))
    cols = np.concatenate([centroid * w[..., None], normal * w[..., None],
                           w[..., None]], axis=-1)
    sums, lengths = _f2_emulation(labels, valid, cols, V, S)
    den = np.where(np.isnan(sums[..., 6]), sums[..., 6],
                   np.maximum(sums[..., 6], np.float32(1e-12)))[..., None]
    got = (sums[..., 0:3] / den, sums[..., 3:6] / den, sums[..., 6],
           lengths.astype(np.int32))
    want = fk.face_stats_plain(seg_s, order, t[2], t[3], t[4], t[1], V)
    for g, x in zip(got, want):
        assert g.dtype == x.numpy().dtype
        np.testing.assert_array_equal(_bits(g) if g.dtype == np.float32
                                      else g, _bits(x.numpy())
                                      if g.dtype == np.float32 else x.numpy())


@pytest.mark.parametrize("S", range(1, 9))
def test_f2_order_by_block_is_torch_sort(S):
    """F2's order over the S blocks csrc/faces.cu gives a cloud of n = 1152
    S - 52 rows (one a 1152 rows, up to 8) equals torch.sort(seg,
    stable=True)'s, with negative labels, labels past V and invalid
    rows."""
    n = 1152 * S - 52
    assert min(-(-n // 1152), 8) == S
    rng = np.random.default_rng(S)
    labels = np.minimum(rng.integers(0, n // 7, (2, n)), np.arange(n))
    odd = rng.uniform(size=(2, n))
    labels = np.where(odd < 0.05, rng.integers(-n, 0, (2, n)), labels)
    labels = np.where(odd > 0.95, rng.integers(n, 2 * n, (2, n)), labels)
    valid = rng.uniform(size=(2, n)) < 0.8
    seg_s, order = fk.sorted_labels(torch.from_numpy(labels),
                                    torch.from_numpy(valid), n)
    for b in range(2):
        seg = np.where(valid[b], np.minimum(labels[b], n - 1), n)
        _, got = _f2_order(seg, n, S)
        np.testing.assert_array_equal(got, order[b].numpy())
        np.testing.assert_array_equal(seg[got], seg_s[b].numpy())


def test_negative_labels_are_dropped_as_jax_drops_them():
    """Rows of a negative label add to no slot, in the plain version as in
    the JAX package's one-hot contraction; the labels after them keep the
    sums of their own rows."""
    V = 6
    labels = np.array([[-4, 0, 1, -7, 2, 0]], np.int64)
    valid = np.ones((1, V), bool)
    values = np.arange(1, V + 1, dtype=np.float32)[None]
    j = jax.jit(jax.vmap(functools.partial(jfaces._label_segment_sum, V=V)))(
        jnp.asarray(values), jnp.asarray(labels), jnp.asarray(valid))
    t = fk.label_segment_sum(torch.from_numpy(values),
                             torch.from_numpy(labels),
                             torch.from_numpy(valid), V)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t.numpy(), [[8, 3, 5, 0, 0, 0]])
    labels[0, 3] = -2**40  # past int32, which the JAX package's labels are
    t = fk.label_segment_sum(torch.from_numpy(values),
                             torch.from_numpy(labels),
                             torch.from_numpy(valid), V)
    np.testing.assert_array_equal(t.numpy(), [[8, 3, 5, 0, 0, 0]])
