"""Fine verify's per-candidate join (ops/fine_kernels.py: V1's lookup and
count, V2's places and score) on the CPU.

  - A NumPy emulation of csrc/fine.cu's algorithm (V1: the key of each
    (candidate, target point), its place in the table by the binary search
    over the keys a block holds up to the first sentinel, every stride-th
    where the table has more than it holds, then the keys between two held
    ones; hit and below counted at that place. V2: each slot's place i +
    sum(hit[:i] + below[:i]) + below[i], fold_sum's first level formed from
    the live places alone, left operands first and right ones added, then
    its other levels dense) equals lookup_plain + score_plain bit for bit
    on every edge case (``FINE_CASES``), both at the kernel's table sample
    and at a sample of 7 keys, where every table of 8 keys or more takes
    the two-step search.
  - The plain versions give the bits of the port's join sort before the
    kernels (``_join_sort_reference``, its code as it was) on every case.
  - fine_verify on the CPU (through the wrappers) gives the bits of
    lookup_plain + score_plain called directly, on
    tests/test_torch_verify.py's small pair and its 12 candidates.
  - The wrappers take the plain versions for CPU tensors (building and
    launching nothing) and raise on any other device.

``fine_case`` and ``FINE_CASES`` are jax-free: tests/test_torch_cuda.py
holds the kernels to the plain versions on the card on the same cases."""

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
# csrc/fine.cu's kTableSample: the table keys a V1 block holds.
TABLE_SAMPLE = 32768
FINE_CASES = ("plain", "odd n", "Vf = 1", "empty table", "empty target",
              "outside window", "overflow", "aliased", "NaN and huge T",
              "one live run", "one cell", "large table", "eight pairs")


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
    table" has 40000 table slots (V1 holds every second key, and the
    search ends in the keys between) and a first level of fold_sum longer
    than V2 keeps in shared memory; "eight pairs" is the main path's batch
    of 8 pairs of 12 candidates."""
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
    table = fine.build_source_table(
        torch.from_numpy(src), torch.from_numpy(src_mask), PARAMS,
        TEST_CAPS.replace(max_fine_voxels=Vf))
    return (torch.from_numpy(T), table, torch.from_numpy(tar),
            torch.from_numpy(tar_mask))


# ------------------------------------------------------------ emulation --


def _lower_bound(held, keys):
    """The count of held entries below each key, by csrc/fine.cu's binary
    search (lo, hi halved until they meet), for a vector of keys."""
    lo = np.zeros(keys.shape, np.int64)
    hi = np.full(keys.shape, len(held), np.int64)
    while (lo < hi).any():
        active = lo < hi
        mid = (lo + hi) >> 1
        right = active & (held[np.minimum(mid, len(held) - 1)] < keys)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    return lo


def _table_place(K, held, stride, keys):
    """csrc/fine.cu's table_place: the lower bound among the held keys
    before the first sentinel, then the keys between two held ones one by
    one."""
    lo = _lower_bound(held, keys)
    if stride == 1:
        return lo
    idx = np.where(lo == 0, 0, (lo - 1) * stride + 1)
    end = np.minimum(lo * stride, len(K))
    moving = lo > 0
    for _ in range(stride - 1):
        step = moving & (idx < end) & (K[np.minimum(idx, len(K) - 1)] < keys)
        idx = idx + step
        moving &= step
    return idx


def _v1(T, keys, cmin, cmax, pts, mask, inv, sample):
    """V1 for one pair: hit and below (C, Vf)."""
    C, Vf = T.shape[0], keys.shape[0]
    K = keys.astype(np.uint32)  # the sentinel stays 0xFFFFFFFF
    stride = -(-Vf // sample)
    held = K[::stride]
    held = held[:np.argmax(np.append(held, fk.SENTINEL) == fk.SENTINEL)]
    hit = np.zeros((C, Vf), np.int64)
    below = np.zeros((C, Vf), np.int64)
    p = pts[mask]
    for c in range(C):
        R = T[c]
        x = np.stack([((p[:, 0] * R[r, 0] + p[:, 1] * R[r, 1])
                       + p[:, 2] * R[r, 2]) + R[r, 3] for r in range(3)], -1)
        # torch's CPU cast (numpy's is the same instruction); V1 casts as
        # torch's CUDA cast does, which the card tests hold.
        with np.errstate(invalid="ignore"):
            cell = np.floor(x * inv).astype(np.int32)
        inside = ((cell >= cmin) & (cell <= cmax)).all(-1)
        cell = cell[inside]
        key = (((cell[:, 0] & 1023).astype(np.uint32) << 20)
               | ((cell[:, 1] & 1023).astype(np.uint32) << 10)
               | (cell[:, 2] & 1023).astype(np.uint32))
        idx = _table_place(K, held, stride, key)
        safe = np.minimum(idx, Vf - 1)
        j = safe // stride
        at = np.where(safe % stride != 0, K[safe],
                      np.where(j < len(held),
                               np.append(held, 0)[np.minimum(j, len(held))],
                               fk.SENTINEL))
        counted = (idx < Vf) & (at != fk.SENTINEL)
        np.add.at(hit[c], idx[counted & (at == key)], 1)
        np.add.at(below[c], idx[counted & (at != key)], 1)
    return hit, below


def _v2(hit, below, counts, n_src, mask):
    """V2 for one pair: the scores (C,)."""
    C, Vf = hit.shape
    n = Vf + mask.shape[0]
    h, width = n // 2, n // 2 + n % 2
    total = np.float32(n_src) + np.float32(mask.sum())
    out = np.zeros(C, np.float32)
    one = np.float32(1.0)
    for c in range(C):
        H, B = hit[c], below[c]
        before = np.concatenate([[0], np.cumsum(H + B)[:-1]])
        place = np.arange(Vf) + before + B
        t = (H + 1).astype(np.float32) - one
        s = counts
        v = (s + t) * np.minimum(s, t) / np.maximum(np.maximum(s, t), one)
        live = H >= 1
        y = np.zeros(width, np.float32)
        left = live & (place < h)
        y[place[left]] = v[left]
        carry = live & (place == 2 * h)
        if carry.any():
            y[h] = v[carry][0]
        right = live & (place >= h) & (place < 2 * h)
        y[place[right] - h] = y[place[right] - h] + v[right]
        L = width
        while L > 1:
            half = L // 2
            y[:half] = y[:half] + y[half:2 * half]
            if L % 2:
                y[half] = y[2 * half]
            L = half + L % 2
        out[c] = y[0] / max(total, one)
    return out


def emulate(T, table, tar_pts, tar_mask, sample=TABLE_SAMPLE):
    """csrc/fine.cu's V1 and V2 in NumPy, a pair at a time: (hit, below,
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
                         inv, sample)
        hits.append(hit)
        belows.append(below)
        scores.append(_v2(hit, below, counts[b], n_src[b], mask[b]))
    return (np.stack(hits).reshape(lead + (C, Vf)),
            np.stack(belows).reshape(lead + (C, Vf)),
            np.stack(scores).reshape(lead + (C,)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("sample", [TABLE_SAMPLE, 7])
@pytest.mark.parametrize("name", FINE_CASES)
def test_emulation_equals_plain(name, sample):
    T, table, tar_pts, tar_mask = fine_case(name)
    hit, below = fk.lookup_plain(T, table, tar_pts, tar_mask, PARAMS)
    score = fk.score_plain(hit, below, table, tar_mask)
    e_hit, e_below, e_score = emulate(T, table, tar_pts, tar_mask, sample)
    np.testing.assert_array_equal(hit.numpy(), e_hit)
    np.testing.assert_array_equal(below.numpy(), e_below)
    np.testing.assert_array_equal(_bits(score.numpy()), _bits(e_score))
    live = (hit > 0).sum(-1)
    if name in ("empty table", "empty target", "outside window"):
        assert not live.any() and not score.any()
    elif name == "one live run":
        assert bool((live <= 1).all()) and bool((live[:, 0] == 1).all())
    else:
        assert bool((score > 0).any())


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
    counts = (fk.LOOKUPS, fk.SCORES)
    score, aliased = fine.fine_verify(T, table, spts, smask, tparams, tcaps)
    hit, below = fk.lookup_plain(T, table, spts, smask, tparams)
    want = fk.score_plain(hit, below, table, smask)
    assert score.shape == (12,) and aliased.shape == (12,)
    np.testing.assert_array_equal(_bits(score.numpy()), _bits(want.numpy()))
    np.testing.assert_array_equal(
        _bits(score.numpy()),
        _bits(_join_sort_reference(T, table, spts, smask, tparams).numpy()))
    assert (fk.LOOKUPS, fk.SCORES) == counts
    assert bool((score > 0.05).any())


def test_wrappers_raise_on_another_device():
    T, table, tar_pts, tar_mask = fine_case("plain")
    meta = type(table)(*(x.to("meta") for x in table))
    with pytest.raises(ValueError, match="unsupported device"):
        fk.lookup(T.to("meta"), meta, tar_pts.to("meta"),
                  tar_mask.to("meta"), PARAMS)
    hit, below = fk.lookup(T, table, tar_pts, tar_mask, PARAMS)
    with pytest.raises(ValueError, match="unsupported device"):
        fk.score(hit.to("meta"), below.to("meta"), meta, tar_mask.to("meta"))
