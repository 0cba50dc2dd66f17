"""Fine verify's per-candidate join (ops/fine_kernels.py: the lookup and
count, the places and the score, one kernel on a card) on the CPU.

  - A NumPy emulation of csrc/fine.cu's join (R, the first sentinel, in
    the bracket between two sampled keys; the table as 16-bit offsets in
    buckets of 2^16 keys from the first key to the last, each bucket's
    first slot, empty ones filled by a suffix min; each key's place past
    the last key R, else by its bucket's slot range and a binary search
    of the offsets, or, past 65535 slots, where the kernel takes its
    scratch form, by a binary search of the keys; hit and below
    counted at that place by the cluster rank that owns it, S = ceil(R /
    K) slots a rank, packed in one 32-bit word where M < 65536; each
    rank's places in rounds of 8192 slots after the ranks before it; the
    live values in slot order and a bitmap of the live places; fold_sum's
    first level no longer than the dense level, or its fourth, formed from
    the live places alone, each entry with a live leaf summed over its
    subtree's leaves in the tree's order, then its other levels dense)
    equals
    lookup_plain + score_plain bit for bit on every edge case
    (``FINE_CASES``), in clusters of 1 block with the kernel's dense level
    and in clusters of 4 with a dense level of n / 16 or 64 (a fold of 4
    levels from the live places, the kernel's most), and in clusters of 2
    and 8 where the table's R slots do not divide among the ranks. The
    cases the kernel takes in clusters of 2, 4 and 8 blocks or in its
    scratch (``FINE_CLUSTERS``) are the sizes that choose them: default
    caps, 40000 slots, an escalation of auto caps, ``--caps large`` and
    more than 2^18 places.
  - The packed counts would wrap past 65535 (a case of 70000 keys in one
    cell): the emulation takes two words a slot from M = 65536 on, as the
    kernel does.
  - The plain versions give the bits of the port's join sort before the
    kernels (``_join_sort_reference``, its code as it was) on every case.
  - fine_verify on the CPU (through the wrapper) gives the bits of
    lookup_plain + score_plain called directly, on
    tests/test_torch_verify.py's small pair and its 12 candidates.
  - The wrapper takes the plain versions for CPU tensors (building and
    launching nothing) and raises on any other device.

``fine_case`` and ``FINE_CASES`` are jax-free: tests/test_torch_cuda.py
holds the kernel to the plain versions on the card on the same cases."""

import numpy as np
import pytest
import torch

from fccf_pcr_torch.config import TEST_CAPS, FCCFParams
from fccf_pcr_torch.ops import fine_kernels as fk
from fccf_pcr_torch.ops import scan
from fccf_pcr_torch.ops.batch import fold_sum, small_matmul
from fccf_pcr_torch.ops.sorting import cosort
from fccf_pcr_torch.ops.voxelize import cell_index
from fccf_pcr_torch.verify import fine

PARAMS = FCCFParams()
# csrc/fine.cu's kBucketShift, kBuckets, kFoldLevel and the round of slots
# a rank's block walks at once (kThreads * kSlots).
BUCKET_SHIFT = 16
BUCKETS = 1 << 14
FOLD_LEVEL = 16384
CHUNK = 1024 * 8
MAX_DEPTH = 4
FINE_CASES = ("plain", "odd n", "Vf = 1", "empty table", "empty target",
              "outside window", "overflow", "aliased", "NaN and huge T",
              "one live run", "one cell", "large table", "eight pairs",
              "uneven ranks", "count past 65535", "default caps",
              "escalated auto", "large caps", "deep fold")
# The least cluster the kernel takes a case in where it is not 1 block
# (fccf_fine_join_shared); 0: none holds it, the share goes to the
# scratch.
FINE_CLUSTERS = {"default caps": 2, "large table": 4, "escalated auto": 8,
                 "large caps": 0, "deep fold": 0}


def _poses(rng, P, C, spread=0.3):
    """C candidate poses a pair near the identity (rotations of a few
    degrees, translations of ~spread m); candidate 0 is the identity."""
    T = np.tile(np.eye(4), (P, C, 1, 1))
    for b in range(P):
        for c in range(1, C):
            w = rng.normal(0, 0.03, 3)
            K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                          [-w[1], w[0], 0]])
            T[b, c, :3, :3] = np.eye(3) + K + K @ K / 2
            T[b, c, :3, 3] = rng.normal(0, spread, 3)
    return T.astype(np.float32)


def fine_case(name):
    """One edge case of fine verify's join: (T (P, C, 4, 4), table, tar_pts
    (P, M, 3), tar_mask (P, M)), CPU tensors, the table built by
    build_source_table from a seeded source cloud and the target points
    drawn from it with 5 cm of noise, so most candidates hit. "large
    table" has 40000 table slots (the kernel's least cluster is then 2
    blocks a candidate) and 140000 places, four levels of fold_sum above
    its dense one; "eight pairs" is the main path's batch of 8 pairs of 12
    candidates; "uneven ranks" a full table of 13 slots (4, 4, 4 and 1 a
    rank in clusters of 4; 2 a rank and none for the last in clusters of
    8); "count past 65535" 70000 target points in one cell, so a hit
    count that 16 bits do not hold. The sizes that choose the kernel's
    other forms (``FINE_CLUSTERS``): "default caps" the default
    Capacities' 32768 slots and 65536 points (two-word counts); "escalated
    auto" auto_escalation_caps of an auto_caps with 65536 residual points
    (59392 slots, 131072 points); "large caps" the CLI's ``--caps large``
    (65536 slots, 131072 points) and "deep fold" 70000 slots, every one
    occupied (the table overflows), and 270000 points (n > 2^18, so fold_sum's
    fourth level is longer than the dense one)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    P, C, Vf, Ms, M, extent = 2, 6, 512, 400, 500, 6.0
    if name == "odd n":
        M = 501
    elif name == "Vf = 1":
        Vf = 1
    elif name == "overflow":
        Vf = 32
    elif name == "large table":
        P, C, Vf, Ms, M, extent = 1, 3, 40000, 60000, 100000, 20.0
    elif name == "eight pairs":
        P, C = 8, 12
    elif name == "uneven ranks":
        Vf = 13
    elif name == "count past 65535":
        P, C, M = 1, 2, 70000
    elif name == "default caps":
        P, C, Vf, Ms, M, extent = 1, 3, 32768, 30000, 65536, 20.0
    elif name == "escalated auto":
        P, C, Vf, Ms, M, extent = 1, 2, 59392, 50000, 131072, 30.0
    elif name == "large caps":
        P, C, Vf, Ms, M, extent = 1, 2, 65536, 60000, 131072, 30.0
    elif name == "deep fold":
        P, C, Vf, Ms, M, extent = 1, 2, 70000, 90000, 270000, 40.0
    src = rng.uniform(-extent, extent, (P, Ms, 3)).astype(np.float32)
    src_mask = rng.uniform(size=(P, Ms)) < 0.9
    pick = rng.integers(0, Ms, (P, M))
    tar = (np.take_along_axis(src, pick[..., None], 1)
           + rng.normal(0, 0.05, (P, M, 3))).astype(np.float32)
    tar_mask = rng.uniform(size=(P, M)) < 0.85
    T = _poses(rng, P, C)
    if name == "empty table":
        src_mask[:] = False
    elif name == "empty target":
        tar_mask[:] = False
    elif name == "outside window":
        tar += np.float32(100.0)
    elif name == "aliased":
        src[:, 0] = (700.0, 0.0, 0.0)  # a span of 1400 cells of 0.5 m
        src_mask[:, 0] = True
    elif name == "NaN and huge T":
        T[0, 1, 0, 3] = np.nan
        T[0, 2, :3, 3] = 1e30
        T[1, 0, 1, 3] = -3e9
        T[1, 3, 0, 0] = np.nan
        T[1, 4, :3, 3] = (1e8, -1e8, 5e9)
    elif name == "one live run":
        tar[:, 0] = src[:, 0]
        tar_mask[:] = False
        tar_mask[:, 0] = True
        src_mask[:, 0] = True
    elif name == "one cell":
        tar[:] = src[:, :1]
        src_mask[:, 0] = True
    elif name == "count past 65535":
        tar[:] = src[:, :1]
        src_mask[:, 0] = True
        tar_mask[:] = True
    table = fine.build_source_table(
        torch.from_numpy(src), torch.from_numpy(src_mask), PARAMS,
        TEST_CAPS.replace(max_fine_voxels=Vf))
    return (torch.from_numpy(T), table, torch.from_numpy(tar),
            torch.from_numpy(tar_mask))


# ------------------------------------------------------------ emulation --


def _table(keys):
    """csrc/fine.cu's table of one pair: (R, key_0, the last occupied key,
    the occupied keys' 16-bit offsets from key_0, and the first slot of
    each bucket of 2^16 keys from key_0 to the last key, an empty
    bucket's the next one's, past the last R). R is the first sentinel,
    found in the bracket after the last occupied one of the sampled keys
    (every ceil(Vf / 1024)-th)."""
    K = keys.astype(np.uint32)  # the sentinel stays 0xFFFFFFFF
    Vf = len(K)
    stride = -(-Vf // 1024)
    sampled = np.flatnonzero(K[::stride] == fk.SENTINEL)
    first = int(sampled[0]) if len(sampled) else -(-Vf // stride)
    lo, hi = (0, 0) if first == 0 else ((first - 1) * stride + 1,
                                        min(first * stride, Vf))
    gap = np.flatnonzero(K[lo:hi] == fk.SENTINEL)
    R = 0 if first == 0 else lo + int(gap[0]) if len(gap) else hi
    assert R == int((K != fk.SENTINEL).sum())
    k0, kmax = K[0], K[R - 1] if R else np.uint32(0)
    if Vf > 65535:  # the scratch form: no buckets
        return R, k0, kmax, None, None
    d = K[:R] - k0
    offs = (d & 0xFFFF).astype(np.uint16)
    bucket = d >> BUCKET_SHIFT
    buckets = int((kmax - k0) >> BUCKET_SHIFT) + 1 if R else 0
    starts = np.full(buckets + 1, 0xFFFF, np.int64)
    first_slot = np.ones(R, bool)
    first_slot[1:] = bucket[1:] != bucket[:-1]
    starts[bucket[first_slot]] = np.flatnonzero(first_slot)
    starts = np.minimum.accumulate(starts[::-1])[::-1]
    starts[starts == 0xFFFF] = R
    assert buckets <= BUCKETS
    return R, k0, kmax, offs, starts.astype(np.uint16)


def _place(R, k0, kmax, offs, starts, key):
    """Each key's place in the table and whether it is a hit: past the
    last occupied key R; below key 0 place 0; else its bucket's slot range
    and a binary search of the offsets in it."""
    low, high = key < k0, key > kmax
    d = np.where(low | high, 0, key - k0).astype(np.uint32)
    q = (d & 0xFFFF).astype(np.int64)
    lo = starts[d >> BUCKET_SHIFT].astype(np.int64)
    hi = starts[(d >> BUCKET_SHIFT) + 1].astype(np.int64)
    top = hi.copy()
    o = np.append(offs, 0).astype(np.int64)
    while (lo < top).any():
        active = lo < top
        mid = (lo + top) >> 1
        right = active & (o[mid] < q)
        lo = np.where(right, mid + 1, lo)
        top = np.where(active & ~right, mid, top)
    hit = ~low & ~high & (lo < hi) & (o[np.minimum(lo, len(offs))] == q)
    return np.where(high, R, np.where(low, 0, lo)), hit


def _search(keys, R, key):
    """The scratch form's place of each key: a binary search of the R
    occupied keys (the lower bound), and whether it is a hit."""
    K = keys[:R].astype(np.uint32)
    idx = np.searchsorted(K, key)
    return idx, (idx < R) & (K[np.minimum(idx, max(R - 1, 0))] == key)


def _v1(T, keys, cmin, cmax, pts, mask, inv, K):
    """The counts of one pair's candidates: (hit, below), (C, Vf), as the
    ranks of a cluster of K blocks hold them (S = ceil(R / K) slots a
    rank; one 32-bit word a slot, hit + 65536 below, where M < 65536);
    past 65535 slots each key placed as the scratch form places it."""
    C, Vf, M = T.shape[0], keys.shape[0], mask.shape[0]
    R, k0, kmax, offs, starts = _table(keys)
    S = max(1, -(-R // K))
    hit = np.zeros((C, Vf), np.int64)
    below = np.zeros((C, Vf), np.int64)
    p = pts[mask]
    for c in range(C):
        Rc = T[c]
        x = np.stack([((p[:, 0] * Rc[r, 0] + p[:, 1] * Rc[r, 1])
                       + p[:, 2] * Rc[r, 2]) + Rc[r, 3] for r in range(3)], -1)
        # torch's CPU cast (numpy's is the same instruction); the kernel
        # casts as torch's CUDA cast does, which the card tests hold.
        with np.errstate(invalid="ignore"):
            cell = np.floor(x * inv).astype(np.int32)
        inside = ((cell >= cmin) & (cell <= cmax)).all(-1)
        cell = cell[inside]
        key = (((cell[:, 0] & 1023).astype(np.uint32) << 20)
               | ((cell[:, 1] & 1023).astype(np.uint32) << 10)
               | (cell[:, 2] & 1023).astype(np.uint32))
        idx, is_hit = (_place(R, k0, kmax, offs, starts, key)
                       if Vf <= 65535 else _search(keys, R, key))
        counted = idx < R
        for r in range(K):  # the ranks' slots
            mine = counted & (idx // S == r)
            at = idx[mine] - r * S
            words = np.zeros((2, S), np.uint32)
            if M < 65536:
                np.add.at(words[0], at, np.where(is_hit[mine], 1, 0x10000)
                          .astype(np.uint32))
                words = (words[0] & 0xFFFF, words[0] >> 16)
            else:
                np.add.at(words[0], at[is_hit[mine]], np.uint32(1))
                np.add.at(words[1], at[~is_hit[mine]], np.uint32(1))
            n_r = max(0, min(R - r * S, S))
            hit[c, r * S:r * S + n_r] = words[0][:n_r]
            below[c, r * S:r * S + n_r] = words[1][:n_r]
    return hit, below


def _fold(place, value, n, level):
    """fold_sum of the join's n places, +0.0 but at ``place`` where it is
    ``value``, as the kernel forms it: its first level no longer than
    ``level``, or level MAX_DEPTH (level k), each entry Q from its
    subtree's 2^k leaves Q +
    off[t] (Q < lim[t], else t is an odd carry's missing operand), +0.0
    where a leaf is no live place, summed in the tree's order, x + y in
    the tree's pairs; then fold_sum's other levels."""
    halves, L = [], n
    while L > level and len(halves) < MAX_DEPTH:
        halves.append(L >> 1)
        L = (L >> 1) + (L & 1)
    depth = len(halves)
    x = np.zeros(n, np.float32)
    x[place] = value
    Q = np.arange(L)
    v = []
    for t in range(1 << depth):
        off, lim = 0, 1 << 62  # from the top level down
        for j in range(depth - 1, -1, -1):
            if t >> j & 1:
                off += halves[j]
            else:
                lim = min(lim, halves[j] - off)
        v.append(np.where(Q < lim, x[np.minimum(Q + off, n - 1)],
                          np.float32(0.0)))
    for j in range(depth):
        for t in range(0, 1 << depth, 2 << j):
            v[t] = v[t] + v[t + (1 << j)]
    y = v[0]
    while len(y) > 1:
        h = len(y) // 2
        y = np.concatenate([y[:h] + y[h:2 * h], y[2 * h:]])
    return y[0]


def _v2(hit, below, counts, n_src, mask, K, level):
    """The scores of one pair's candidates (C,): each rank's places in
    chunks of CHUNK slots after the ranks before it, the live values in
    slot order, then ``_fold``."""
    C, Vf = hit.shape
    n = Vf + mask.shape[0]
    R = int((counts > 0).sum())
    S = max(1, -(-R // K))
    total = np.float32(n_src) + np.float32(mask.sum())
    one = np.float32(1.0)
    out = np.zeros(C, np.float32)
    for c in range(C):
        H, B = hit[c], below[c]
        place, value, before = [], [], 0
        for r in range(K):
            for j0 in range(r * S, min(R, (r + 1) * S), CHUNK):
                i = np.arange(j0, min(j0 + CHUNK, R, (r + 1) * S))
                h, b = H[i], B[i]
                before_i = np.concatenate([[0], np.cumsum(h + b)[:-1]])
                p = i + before + before_i + b
                t = (h + 1).astype(np.float32) - one
                s = counts[i]
                v = (s + t) * np.minimum(s, t) / np.maximum(np.maximum(s, t),
                                                             one)
                place.append(p[h >= 1])
                value.append(v[h >= 1])
                before += int((h + b).sum())
        place = np.concatenate(place + [np.zeros(0, np.int64)]).astype(
            np.int64)
        value = np.concatenate(value + [np.zeros(0, np.float32)])
        out[c] = _fold(place, value.astype(np.float32), n, level) / max(total,
                                                                       one)
    return out


def emulate(T, table, tar_pts, tar_mask, K=1, level=FOLD_LEVEL):
    """csrc/fine.cu's join in NumPy, a pair at a time, in clusters of K
    blocks with a dense level no longer than ``level``: (hit, below,
    score), shaped as lookup_plain's and score_plain's."""
    lead = tuple(tar_mask.shape[:-1])
    C, Vf, M = T.shape[-3], table.keys.shape[-1], tar_mask.shape[-1]

    def rows(x, *tail):
        return x.numpy().reshape((-1,) + tail)

    T_, keys = rows(T, C, 4, 4), rows(table.keys, Vf)
    cmin, cmax = rows(table.cell_min, 3), rows(table.cell_max, 3)
    pts, mask = rows(tar_pts, M, 3), rows(tar_mask, M)
    counts, n_src = rows(table.counts, Vf), rows(table.n_src)
    inv = np.float32(1.0) / np.float32(PARAMS.fine_voxel)
    hits, belows, scores = [], [], []
    for b in range(keys.shape[0]):
        hit, below = _v1(T_[b], keys[b], cmin[b], cmax[b], pts[b], mask[b],
                         inv, K)
        hits.append(hit)
        belows.append(below)
        scores.append(_v2(hit, below, counts[b], n_src[b], mask[b], K, level))
    return (np.stack(hits).reshape(lead + (C, Vf)),
            np.stack(belows).reshape(lead + (C, Vf)),
            np.stack(scores).reshape(lead + (C,)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _equal_plain(name, K, level):
    T, table, tar_pts, tar_mask = fine_case(name)
    hit, below = fk.lookup_plain(T, table, tar_pts, tar_mask, PARAMS)
    score = fk.score_plain(hit, below, table, tar_mask)
    e_hit, e_below, e_score = emulate(T, table, tar_pts, tar_mask, K, level)
    np.testing.assert_array_equal(hit.numpy(), e_hit)
    np.testing.assert_array_equal(below.numpy(), e_below)
    np.testing.assert_array_equal(_bits(score.numpy()), _bits(e_score))
    return hit, score


@pytest.mark.parametrize("cluster", ["1 block", "4 blocks, deep fold"])
@pytest.mark.parametrize("name", FINE_CASES)
def test_emulation_equals_plain(name, cluster):
    _, table, _, tar_mask = fine_case(name)
    n = table.keys.shape[-1] + tar_mask.shape[-1]
    K, level = ((1, FOLD_LEVEL) if cluster == "1 block"
                else (4, max(64, -(-n // 16))))
    hit, score = _equal_plain(name, K, level)
    live = (hit > 0).sum(-1)
    if name in ("empty table", "empty target", "outside window"):
        assert not live.any() and not score.any()
    elif name == "one live run":
        assert bool((live <= 1).all()) and bool((live[:, 0] == 1).all())
    else:
        assert bool((score > 0).any())
    if name == "count past 65535":
        assert int(hit.max()) > 65535


@pytest.mark.parametrize("K", [2, 8])
def test_emulation_uneven_ranks(K):
    """A full table of 13 slots over 2 or 8 ranks (7 + 6; 2 a rank and
    none for the last), with a fold of 4 levels."""
    _, table, _, _ = fine_case("uneven ranks")
    assert bool(((table.keys != fk.SENTINEL).sum(-1) == 13).all())
    _equal_plain("uneven ranks", K, 64)


def test_counts_past_65535_take_two_words():
    """70000 keys in one cell: one packed word a slot would carry the hit
    count into below, so from M = 65536 on the kernel keeps two words."""
    T, table, tar_pts, tar_mask = fine_case("count past 65535")
    hit, below = fk.lookup_plain(T, table, tar_pts, tar_mask, PARAMS)
    assert tar_mask.shape[-1] >= 65536 and int(hit.max()) > 65535
    packed = (hit.numpy().astype(np.uint32)
              + (below.numpy().astype(np.uint32) << 16))
    assert not np.array_equal(packed & 0xFFFF, hit.numpy())
    e_hit, e_below, _ = emulate(T, table, tar_pts, tar_mask)
    np.testing.assert_array_equal(e_hit, hit.numpy())
    np.testing.assert_array_equal(e_below, below.numpy())


# ------------------------------------------ the join sort, as it was --


def _join_sort_reference(T, table, tar_pts, tar_mask, params):
    """fine_verify's scores as the port computed them before its kernels:
    one stable sort of [table keys ++ candidate keys] a candidate, the runs'
    ends by a reversed running min, each run scored at its start."""
    lead = tuple(tar_mask.shape[:-1])
    C = T.shape[-3]
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tar_t = small_matmul(tar_pts[..., None, :, :], R.mT) + t[..., None, :]
    cells_t = cell_index(tar_t, params.fine_voxel)
    in_win = torch.all(
        (cells_t >= table.cell_min[..., None, None, :])
        & (cells_t <= table.cell_max[..., None, None, :]), dim=-1)
    keys_t = fk.pack_cells(cells_t, tar_mask[..., None, :] & in_win)
    Vf, M = table.keys.shape[-1], keys_t.shape[-1]
    n = Vf + M
    sent = fk.SENTINEL
    ks2 = torch.where(table.keys != sent, table.keys << 1, sent)
    kt2 = torch.where(keys_t != sent, (keys_t << 1) | 1, sent)
    keys = torch.cat([ks2[..., None, :].expand(lead + (C, Vf)), kt2], dim=-1)
    vals = torch.cat([table.counts[..., None, :].expand(lead + (C, Vf)),
                      torch.ones(lead + (C, M), dtype=torch.float32)], dim=-1)
    k_s, val_s = cosort((keys,), (vals,), dim=-1)
    src_s = (k_s & 1) == 0
    pos = torch.arange(n)
    cell = k_s >> 1
    start_flag = torch.cat([torch.ones_like(cell[..., :1], dtype=torch.bool),
                            cell[..., 1:] != cell[..., :-1]], dim=-1)
    nxt = scan.rev_cummin(torch.where(start_flag, pos, n))
    nxt = torch.cat([nxt[..., 1:], torch.full_like(nxt[..., :1], n)], dim=-1)
    has_src = start_flag & src_s
    s_cnt = torch.where(has_src, val_s, 0.0)
    t_cnt = (nxt - pos).to(torch.float32) - has_src.to(torch.float32)
    live = start_flag & has_src & (t_cnt >= 1.0) & (k_s != sent)
    mn = torch.minimum(s_cnt, t_cnt)
    mx = torch.maximum(s_cnt, t_cnt)
    similar = fold_sum(torch.where(
        live, (s_cnt + t_cnt) * mn / torch.clamp(mx, min=1.0), 0.0), dim=-1)
    total = table.n_src + torch.sum(tar_mask.to(torch.float32), dim=-1)
    return similar / torch.clamp(total, min=1.0)[..., None]


@pytest.mark.parametrize("name", FINE_CASES)
def test_plain_versions_keep_the_join_sort_bits(name):
    T, table, tar_pts, tar_mask = fine_case(name)
    score, aliased = fine.fine_verify(T, table, tar_pts, tar_mask, PARAMS,
                                      TEST_CAPS)
    want = _join_sort_reference(T, table, tar_pts, tar_mask, PARAMS)
    np.testing.assert_array_equal(_bits(score.numpy()), _bits(want.numpy()))
    assert torch.equal(aliased, table.aliased[..., None].expand(score.shape))
    assert bool(table.aliased.all()) == (name == "aliased")
    if name == "overflow":
        assert bool(table.overflow.all())


# ----------------------------------------------- the wrappers on the CPU --


@pytest.fixture(scope="module")
def verify_pair(small_pair, params, caps):
    """tests/test_torch_verify.py's fine inputs: the small pair's residual
    clouds after the JAX package's voxel downsample and compaction, the
    target's table, and the 12 first representative transforms of its
    clustered hypotheses (``stage_inputs``)."""
    import dataclasses

    import jax

    from fccf_pcr_tpu.cluster import cluster as jcl
    from fccf_pcr_tpu.hypotheses import bases as jbases
    from fccf_pcr_tpu.hypotheses import transforms as jtr
    from fccf_pcr_tpu.ops import geometry as jgeo
    from fccf_pcr_tpu.ops import voxelize as jvox
    from fccf_pcr_torch import interop
    from test_torch_hypotheses import jax_pair_faces

    f1, f2 = jax_pair_faces(small_pair, params, caps)
    reps = jax.jit(lambda a, b: jcl.cluster_hypotheses(
        jtr.generate_hypotheses(a, b, jbases.select_bases(a, params),
                                jbases.select_bases(b, params), params, caps),
        params, caps))(f1, f2)
    rep_T = np.asarray(jgeo.make_transform(jgeo.quat_to_matrix(reps.quat),
                                           reps.t))
    T = rep_T[np.asarray(reps.valid)][:12]
    src_p, src_m, tar_p, tar_m, _ = small_pair
    vox = jax.jit(lambda p, m: jvox.voxel_grid_downsample(p, m, 0.25))
    tp, tm, _ = vox(tar_p, tar_m)
    sp, sm, _ = vox(src_p, src_m)
    tmask, tpts = (np.array(a) for a in jvox.compact(tm, 2048, tp)[2:])
    smask, spts = (np.array(a) for a in jvox.compact(sm, 2048, sp)[2:])
    tparams = interop.params_from_reference(dataclasses.asdict(params))
    tcaps = interop.caps_from_reference(dataclasses.asdict(caps))
    table = fine.build_source_table(torch.from_numpy(tpts),
                                    torch.from_numpy(tmask), tparams, tcaps)
    return (torch.from_numpy(T), table, torch.from_numpy(spts),
            torch.from_numpy(smask), tparams, tcaps)


def test_fine_verify_takes_the_plain_versions_on_the_cpu(verify_pair,
                                                         monkeypatch):
    """fine_verify's bits on the CPU are lookup_plain + score_plain's, and
    it builds and launches nothing."""
    T, table, spts, smask, tparams, tcaps = verify_pair

    def refused(*a, **k):
        raise AssertionError("a CPU call built or launched a kernel")

    monkeypatch.setattr(fk, "build", refused)
    counts = fk.JOINS
    score, aliased = fine.fine_verify(T, table, spts, smask, tparams, tcaps)
    hit, below = fk.lookup_plain(T, table, spts, smask, tparams)
    want = fk.score_plain(hit, below, table, smask)
    assert score.shape == (12,) and aliased.shape == (12,)
    np.testing.assert_array_equal(_bits(score.numpy()), _bits(want.numpy()))
    np.testing.assert_array_equal(
        _bits(score.numpy()),
        _bits(_join_sort_reference(T, table, spts, smask, tparams).numpy()))
    assert fk.JOINS == counts
    assert bool((score > 0.05).any())


def test_wrappers_raise_on_another_device():
    T, table, tar_pts, tar_mask = fine_case("plain")
    meta = type(table)(*(x.to("meta") for x in table))
    with pytest.raises(ValueError, match="unsupported device"):
        fk.join(T.to("meta"), meta, tar_pts.to("meta"), tar_mask.to("meta"),
                PARAMS)
    np.testing.assert_array_equal(
        _bits(fk.join(T, table, tar_pts, tar_mask, PARAMS).numpy()),
        _bits(fk.join_plain(T, table, tar_pts, tar_mask, PARAMS).numpy()))
