"""The hypotheses stage's plain versions (ops/hypotheses_kernels.py: the
bases, H1's matches, H2's slots and H3's emission) on the CPU.

  - They keep the stage's CPU bits from before its kernels (sha256 pins
    of select_bases' and generate_hypotheses' outputs).
  - They match the JAX package's select_bases and generate_hypotheses
    (jax.jit of jax.vmap) from the same seeded NumPy faces, at F = 16 with
    per_match_hits 16 and 48 and at F = 12, with the tolerances of
    tests/test_torch_hypotheses.py: masks, types, counts, order and
    overflow exact; quaternions atol 1e-5; translations atol 1e-4 + rtol
    1e-4 (a 3x3 normal-equation inverse can amplify float32 rounding by
    its condition number).
  - A NumPy emulation of the kernels' selection (H1's ranks of rows, a
    warp's ballots a row, the scans over a rank's rows and over the
    cluster's ranks; H2's runs of equal source bases in its chunks, the
    source table of a match's run, its eligible slots listed and ranked
    by warp ballots 32 at a time; H3's blocks of matches, their sums of
    the pair's counts, the warps' scans, each place's match found by
    halving steps over its warp's ends and the tail split over the
    blocks) equals the plain versions' stable sort and ``compact``, on
    rows with no hit, exactly PER_MATCH hits, more than PER_MATCH, more
    than M matches and more than H hits, and on runs over a chunk
    boundary, cut by the count, one base for every match and a base of
    its own for each; H3's alone gives ``emit_plain``'s outputs bit for
    bit at M = 96 to 4096 (1001 among them), H = 0, 1, below, at and
    above the total, no hit, one match holding every hit, every match
    full, PER_MATCH 16, 48 and 96, blocks of 128, 256 and 1024.
  - A pair alone equals the same pair in a batch of 4, bit for bit.
  - CPU calls build nothing and launch nothing.

The kernels themselves run only on a card (tests/test_torch_cuda.py holds
them to these plain versions)."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fccf_pcr_tpu.config import TEST_CAPS as J_TEST_CAPS
from fccf_pcr_tpu.config import FCCFParams as JParams
from fccf_pcr_tpu.features import faces as jfaces
from fccf_pcr_tpu.hypotheses import bases as jbases
from fccf_pcr_tpu.hypotheses import transforms as jtr
from fccf_pcr_torch.config import TEST_CAPS, FCCFParams
from fccf_pcr_torch.features.faces import Faces
from fccf_pcr_torch.hypotheses.bases import select_bases
from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses
from fccf_pcr_torch.ops import hypotheses_kernels as hk
from fccf_pcr_torch.ops.voxelize import compact

PARAMS = FCCFParams()
HERITAGE_LIKE = TEST_CAPS.replace(max_matches=2048, max_hypotheses=3072,
                                  per_match_hits=48)


def _face_set(rng, F, n):
    """n valid faces of F: unit normals scaled by 0.97-1, centroids in
    [-8, 8]^3, point sizes 50-4000, roughness 0.2-4."""
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals *= rng.uniform(0.97, 1.0, (n, 1))
    pad = F - n
    return dict(
        centroid=np.concatenate([rng.uniform(-8, 8, (n, 3)),
                                 np.zeros((pad, 3))]),
        normal=np.concatenate([normals, np.zeros((pad, 3))]),
        point_size=np.concatenate([rng.uniform(50, 4000, n), np.zeros(pad)]),
        voxel_count=np.concatenate([np.ones(n), np.zeros(pad)]),
        theta=np.concatenate([rng.uniform(0.2, 4.0, n), np.zeros(pad)]),
        valid=np.arange(F) < n)


def _rotated(rng, f, angle_deg=25.0, noise=0.002):
    """The same faces from a rotated, translated frame, the normals a
    little perturbed (so bases match and hypotheses form)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    th = np.deg2rad(angle_deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(size=3)
    v = f["valid"][:, None]
    n = f["normal"] @ R.T + rng.normal(scale=noise, size=f["normal"].shape)
    c = f["centroid"] @ R.T + t
    g = dict(f)
    g["normal"] = np.where(v, n, 0.0)
    g["centroid"] = np.where(v, c, 0.0)
    return g


def face_pairs(seed, P, F, kinds=()):
    """P pairs of face sets (f1, f2) as stacked float32 / int32 / bool
    NumPy arrays by field; ``kinds[k]`` makes pair k an edge case: "none"
    (no valid face), "zero" (zero normals on valid faces), "nan" (a NaN
    normal, a NaN centroid and a NaN point size)."""
    rng = np.random.default_rng(seed)
    f1s, f2s = [], []
    for k in range(P):
        n = int(rng.integers(max(F - 4, 2), F + 1))
        a = _face_set(rng, F, n)
        b = _rotated(rng, a)
        kind = kinds[k] if k < len(kinds) else "plain"
        if kind == "none":
            a["valid"][:] = False
        elif kind == "zero":
            a["normal"][1] = 0.0
            b["normal"][2] = 0.0
        elif kind == "nan":
            a["normal"][0] = np.nan
            b["centroid"][1] = np.nan
            a["point_size"][2] = np.nan
        f1s.append(a)
        f2s.append(b)

    def stack(fs):
        dtype = dict(voxel_count=np.int32, valid=bool)
        return {k: np.stack([f[k] for f in fs]).astype(dtype.get(k,
                                                                 np.float32))
                for k in Faces._fields}
    return stack(f1s), stack(f2s)


def to_port(arrays):
    return Faces(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# The stage's CPU outputs before its kernels were added, on face_pairs'
# inputs: sha256 (first 16 hex digits) of both clouds' select_bases and of
# generate_hypotheses, at TEST_CAPS and at heritage-like caps (M 2048, H
# 3072, per_match_hits 48). (seed, P, F, kinds) -> (bases, test, heritage).
DIGESTS = {
    (0, 3, 16, ()): ("7d4494de2a724c4d", "63dbe250ba2293e6",
                     "aa80043e2eaf4636"),
    (1, 4, 16, ("nan", "zero", "none", "plain")): (
        "555a645eb8adb234", "3bd8bb9e09c90c70", "327e15d1dd84c918"),
    (2, 2, 24, ()): ("442fd86994b4921d", "8935ac14fcf22eaa",
                     "13b2b2d1ff824d1f"),
    (3, 2, 5, ()): ("76a5cde98851db11", "4411b5fd8d7410a3",
                    "016cdf41645fe1a0"),
}


@pytest.mark.parametrize("case", sorted(DIGESTS))
def test_cpu_outputs_keep_their_bits(case):
    f1, f2 = (to_port(a) for a in face_pairs(*case))
    b1, b2 = select_bases(f1, PARAMS), select_bases(f2, PARAMS)
    want = DIGESTS[case]
    assert _digest(list(b1) + list(b2)) == want[0]
    for caps, digest in ((TEST_CAPS, want[1]), (HERITAGE_LIKE, want[2])):
        assert _digest(generate_hypotheses(f1, f2, PARAMS, caps)) == digest


# --------------------------------------------------------- against JAX --


def _jax_stage(f1, f2, caps):
    """The JAX package's select_bases and generate_hypotheses, jitted and
    vmapped over the pairs of NumPy faces f1, f2."""
    params = JParams()
    jcaps = dataclasses.replace(J_TEST_CAPS, **{
        f: getattr(caps, f) for f in ("max_matches", "max_hypotheses",
                                      "per_match_hits")})

    def one(a, b):
        ba, bb = jbases.select_bases(a, params), jbases.select_bases(b, params)
        return ba, bb, jtr.generate_hypotheses(a, b, ba, bb, params, jcaps)

    faces = [jfaces.Faces(**{k: jnp.asarray(v) for k, v in f.items()})
             for f in (f1, f2)]
    return jax.jit(jax.vmap(one))(*faces)


@pytest.mark.parametrize("F,per_match_hits", [(16, 16), (16, 48), (12, 16)])
def test_plain_stage_matches_jax(F, per_match_hits):
    f1, f2 = face_pairs(10 + F + per_match_hits, 3, F, ("nan",))
    caps = TEST_CAPS.replace(per_match_hits=per_match_hits)
    jb1, jb2, jh = _jax_stage(f1, f2, caps)
    tf1, tf2 = to_port(f1), to_port(f2)
    for jb, tb in ((jb1, select_bases(tf1, PARAMS)),
                   (jb2, select_bases(tf2, PARAMS))):
        for f in ("i", "j", "type_", "valid"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))
        np.testing.assert_allclose(tb.angle.numpy(), np.asarray(jb.angle),
                                   atol=1e-3)
    th = generate_hypotheses(tf1, tf2, PARAMS, caps)
    for f in ("valid", "type_", "count", "overflow"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)))
    np.testing.assert_allclose(th.quat.numpy(), np.asarray(jh.quat),
                               atol=1e-5)
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-4,
                               atol=1e-4)
    assert int(th.count.min()) > 0


# ------------------------------------- the kernels' selection in NumPy --


def _runs(n, threads):
    """The contiguous run [lo, hi) of n entries each thread takes."""
    run = -(-n // threads)
    return [(min(x * run, n), min(x * run + run, n)) for x in range(threads)]


def _exclusive(counts):
    return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)


def h1_compaction(mask, capacity, ranks=8, threads=512):
    """H1's compaction of one pair's b1-major (B1 x B2) mask: rank r of
    the cluster takes rows [r * rows, (r + 1) * rows), rows = ceil(B1 /
    ranks); a warp a row ballots over the B2 entries 32 a round and
    counts them (the words kept); each row's first place is the
    exclusive scan of the rank's row counts (a run of rows a thread) plus
    the totals of the ranks before it (read from the cluster); the write
    pass places a set lane at its row's place so far plus the set lanes
    below it in the word, and drops places past ``capacity``. Returns
    (the source entry of each kept place, count kept, overflow)."""
    B1, B2 = mask.shape
    rows = -(-B1 // ranks)
    W = -(-B2 // 32)
    words = np.zeros((B1, W * 32), bool)
    words[:, :B2] = mask
    words = words.reshape(B1, W, 32)
    src = np.zeros(capacity, np.int64)
    row_start, totals = [], []
    for r in range(ranks):
        mine = range(min(r * rows, B1), min(r * rows + rows, B1))
        counts = [int(words[a].sum()) for a in mine]
        # The block scan: a run of rows a thread, then within the run.
        sums = [sum(counts[lo:hi]) for lo, hi in _runs(len(mine), threads)]
        pos = []
        for (lo, hi), first in zip(_runs(len(mine), threads),
                                   _exclusive(sums)):
            for c in counts[lo:hi]:
                pos.append(int(first))
                first += c
        row_start.append((mine, pos))
        totals.append(sum(counts))
    total = int(sum(totals))
    kept = min(total, capacity)
    for r, (mine, pos) in enumerate(row_start):
        before = int(sum(totals[:r]))
        for a, p0 in zip(mine, pos):
            at0 = before + p0
            for k in range(W):
                if at0 >= capacity:
                    break
                word = words[a, k]
                below = np.cumsum(word) - word  # set lanes below each lane
                for lane in np.flatnonzero(word):
                    at = at0 + int(below[lane])
                    if at < capacity:
                        src[at] = a * B2 + 32 * k + int(lane)
                at0 += int(word.sum())
    return src, kept, total > capacity


def h2_runs(ij, count, chunk=32):
    """H2's runs of equal source bases: chunk x of ``chunk`` consecutive
    matches takes its matches below ``count``; a match starts a run where
    it is the chunk's first or its (i1, j1) differs from the match before.
    Returns, for each match below count, (its chunk, its run's first
    match)."""
    out = []
    for m0 in range(0, count, chunk):
        first = m0
        for m in range(m0, min(m0 + chunk, count)):
            if m == m0 or ij[m] != ij[m - 1]:
                first = m
            out.append((m0 // chunk, first))
    return out


def h2_ranking(s_ok, t_ok, angle_ok, K):
    """H2's selection for one valid match: the (s, t) slots with s_ok[s]
    and t_ok[t] (the source and target faces the warp's ballots let
    through, listed), in s-major order, which is slot order; a lane a slot
    (entries (e // nt, e % nt) of the lists, moved by 32 = dq nt + dr a
    round), 32 at a time, each round's valid slots ranked by the warp's
    ballot (a lane's rank the popcount of the ballot below it, plus the
    valid slots of the rounds before), the first K kept, no round begun
    once more than K slots are valid; the fallback slot F * F at rank 0
    where no slot is valid. Returns (kept slots, valid slots counted)."""
    F = len(s_ok)
    s_list, t_list = np.flatnonzero(s_ok), np.flatnonzero(t_ok)
    ns, nt = len(s_list), len(t_list)
    E = ns * nt
    kept, running = [], 0
    if E:
        si = np.arange(32) // nt
        ti = np.arange(32) - si * nt
        dq, dr = 32 // nt, 32 - (32 // nt) * nt
    for e0 in range(0, E, 32):
        if running > K:
            break
        ok = np.zeros(32, bool)
        slot = np.zeros(32, np.int64)
        for lane in range(32):
            if e0 + lane < E:
                s, t = s_list[si[lane]], t_list[ti[lane]]
                ok[lane], slot[lane] = angle_ok[s, t], s * F + t
        si, ti = si + dq, ti + dr
        si, ti = np.where(ti >= nt, si + 1, si), np.where(ti >= nt, ti - nt,
                                                           ti)
        ballot = sum(1 << lane for lane in range(32) if ok[lane])
        for lane in np.flatnonzero(ok):
            rank = running + bin(ballot & ((1 << int(lane)) - 1)).count("1")
            if rank < K:
                kept.append((rank, int(slot[lane])))
        running += bin(ballot).count("1")
    if running == 0 and K > 0:
        kept.append((0, F * F))
    return [slot for _, slot in sorted(kept)], running + (running == 0)


# H3's block size (kEmitThreads in csrc/hypotheses.cu); the cases below
# also take blocks of 256 and 1024, so the emulation holds at each.
H3_THREADS = 128


def h3_places(hit_count, H, K, threads=H3_THREADS):
    """H3's places of one pair's hits as its blocks and warps form them.
    Block b takes the matches [b T, (b + 1) T), a thread a match, each
    count held to [0, K]. It sums the counts before its matches and all
    of them as its loads do (groups of 4 where M % 4 == 0, a group before
    the block where its first count is); a warp scans its 32 counts, and
    its run of places starts after the hits before the block and those of
    the warps before it, clipped to min(total, H). The warp writes its run
    32 places a round, lane l place r = r0 + l, whose match is the first
    lane with end > r, found by 5 halving steps over the warp's ends (the
    shuffles), and hit r - (end - count) of it. The places past the kept
    hits go to the blocks in turn (thread t of block b from place kept + b
    T + t, a stride of blocks * T). Asserts every place below H is written
    once. Returns ((kept, 2) rows (match, k) of the kept places, total
    hits)."""
    c = np.clip(np.asarray(hit_count, np.int64), 0, K)
    M = len(c)
    width = 4 if M % 4 == 0 else 1
    groups = c.reshape(-1, width).sum(-1)
    first = np.arange(len(groups)) * width
    total = int(groups.sum())
    kept = min(total, H)
    blocks = max(1, -(-M // threads))
    owner = np.full(H, -1, np.int64)
    hit = np.full(H, -1, np.int64)
    for b in range(blocks):
        start = b * threads
        before = int(groups[first < start].sum())
        own = np.zeros(threads, np.int64)
        mine = c[start:start + threads]
        own[:len(mine)] = mine
        ends = np.cumsum(own.reshape(-1, 32), axis=1)
        warp_before = _exclusive(ends[:, -1])
        for w in range(threads // 32):
            end = ends[w]
            beg = end - own[32 * w:32 * w + 32]
            ws = before + int(warp_before[w])
            n = max(0, min(int(end[-1]), kept - ws))
            # Every round's lanes at once: place r is lane r % 32 of round
            # r // 32, and its search reads the warp's ends alone.
            r = np.arange(n)
            j = np.zeros(n, np.int64)
            for step in (16, 8, 4, 2, 1):
                j = np.where(end[j + step - 1] <= r, j + step, j)
            e = ws + r
            assert (owner[e] == -1).all()
            owner[e] = start + 32 * w + j
            hit[e] = r - beg[j]
    stride = blocks * threads
    for b in range(blocks):
        for i in range(kept + b * threads, H, stride):
            seg = owner[i:i + threads]  # thread t writes place i + t
            assert (seg == -1).all()
            seg[:] = -2
    assert (owner[kept:] == -2).all()
    assert (owner[:kept] >= 0).all()
    assert ((hit[:kept] >= 0) & (hit[:kept] < c[owner[:kept]])).all()
    return np.stack([owner[:kept], hit[:kept]], 1), total


def _source_bases(rng, M, B, runs):
    """Each match's source base (an index of the B bases), b1-major as H1
    emits them: "h1" runs of 1-30 matches a base, "across" a run of 40
    from match 20 (over the boundary of the chunks of 32), "one" every
    match on one base, "own" a base of its own for every match."""
    if runs == "one":
        return np.full(M, 7)
    if runs == "own":
        return np.arange(M) % B
    lengths = rng.integers(1, 31, M)
    if runs == "across":
        lengths[:3] = (8, 12, 40)
    base = np.repeat(np.sort(rng.choice(B, M, replace=False)
                             if M <= B else rng.integers(0, B, M)), lengths)
    return base[:M]


def _slot_tables(rng, M, F, kind, runs):
    """One pair's matches: each match's source base (i1, j1), its source
    faces' tests (one table a base), its target faces' tests, the angle
    test of each (s, t), and the matches' valid flags (the last 3 not, or
    a count that cuts a run short for runs "cut")."""
    ii, jj = np.triu_indices(F, 1)
    B = len(ii)
    base = _source_bases(rng, M, B, "h1" if runs == "cut" else runs)
    density = rng.choice([0.0, 0.3, 0.7, 1.0], B)
    src_ok = rng.uniform(size=(B, F)) < density[:, None]
    src_ok[np.arange(B), ii] = False
    src_ok[np.arange(B), jj] = False
    t_ok = rng.uniform(size=(M, F)) < rng.choice([0.2, 0.8, 1.0], (M, 1))
    angle_ok = rng.uniform(size=(M, F, F)) < rng.choice(
        [0.0, 0.01, 0.05, 0.3], (M, 1, 1))
    if kind == "exact":
        src_ok[:], t_ok[:], angle_ok[:] = True, True, False
        src_ok[np.arange(B), ii] = src_ok[np.arange(B), jj] = False
        for m in range(M):
            s = [x for x in range(F) if x not in (ii[base[m]], jj[base[m]])]
            picks = rng.choice(len(s) * F, 16, replace=False)
            angle_ok[m, np.array(s)[picks // F], picks % F] = True
    elif kind == "dense":
        angle_ok = rng.uniform(size=(M, F, F)) < 0.6
    count = M - 3 if kind != "dense" else M
    if runs == "cut":  # the count falls inside a run of one base
        ends = np.flatnonzero(np.diff(base) != 0)
        long_run = ends[np.argmax(np.diff(ends))] + 1
        count = int(long_run + 1 + (ends[np.argmax(np.diff(ends)) + 1]
                                    - long_run) // 2)
    m_valid = np.arange(M) < count
    return base, ii, jj, src_ok, t_ok, angle_ok, m_valid


@pytest.mark.parametrize("F,K,kind,runs", [
    pytest.param(F, K, kind, runs, id="-".join(
        map(str, (F, K, kind) + ((runs,) * (runs != "h1")))))
    for F, K, kind, runs in (
        (16, 16, "mixed", "h1"), (16, 16, "exact", "h1"),
        (16, 48, "mixed", "h1"), (24, 48, "dense", "h1"),
        (5, 16, "mixed", "h1"), (16, 16, "dense", "h1"),
        (16, 48, "mixed", "across"), (16, 16, "mixed", "cut"),
        (16, 48, "mixed", "one"), (16, 16, "dense", "own"))])
def test_kernel_ranking_equals_sort_and_compact(F, K, kind, runs):
    """H2's runs, its eligible slots and ballots and H3's scan and search
    (NumPy) against the plain versions' stable sort of the negated slot
    index and compact of the hits: runs of equal source bases as H1 emits
    them, one over a chunk boundary, a count that cuts a run, one base for
    every match and a base of its own for each."""
    rng = np.random.default_rng(F * 100 + K + len(runs))
    M, H = 96, 700
    base, ii, jj, src_ok, t_ok, angle_ok, m_valid = _slot_tables(
        rng, M, F, kind, runs)
    ok = (src_ok[base][:, :, None] & t_ok[:, None, :] & angle_ok).reshape(
        M, F * F)
    S = F * F + 1
    Kc = min(K, S)
    fb = ~ok.any(-1)
    slot_valid = np.concatenate(
        [ok & m_valid[:, None], (fb & m_valid)[:, None]], axis=1)
    # The plain versions' selection (hypotheses_kernels.slots_plain and
    # emit_plain).
    tv = torch.from_numpy(slot_valid)
    neg = torch.where(tv, -torch.arange(S), -S - 1)
    vals, idxs = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :Kc], idxs[:, :Kc]
    hit_valid = vals > -S - 1
    flat = torch.arange(M)[:, None] * S + idxs
    count, overflow, h_valid, hflat = compact(hit_valid[None], H, flat[None],
                                              batch_dims=1)
    # The kernels' selection: each match's source faces from its run's
    # table (the base of the run's first match).
    ij = ii[base] | jj[base] << 16
    hit_count = np.zeros(M, np.int64)
    row_over = np.zeros(M, bool)
    kept_slots = {}
    chunks = set()
    for m, (chunk, first) in enumerate(h2_runs(ij, int(m_valid.sum()))):
        chunks.add((chunk, first))
        kept, total = h2_ranking(src_ok[base[first]], t_ok[m], angle_ok[m],
                                 Kc)
        kept_slots[m] = kept
        hit_count[m] = len(kept)
        row_over[m] = total > Kc
        want = idxs[m][hit_valid[m]].numpy()
        np.testing.assert_array_equal(np.array(kept, np.int64), want)
    np.testing.assert_array_equal(hit_count, hit_valid.sum(-1).numpy())
    np.testing.assert_array_equal(row_over,
                                  tv.sum(-1).numpy() > Kc)
    places, total = h3_places(hit_count, H, Kc)
    assert int(count[0]) == min(total, H) == len(places)
    assert bool(overflow[0]) == (total > H)
    got = [m * S + kept_slots[m][k] for m, k in places]
    np.testing.assert_array_equal(np.array(got, np.int64),
                                  hflat[0][h_valid[0]].numpy())
    n_runs = len(chunks)
    valid = int(m_valid.sum())
    if kind == "exact":
        assert (hit_count[m_valid] == 16).all() and not row_over.any()
    if kind == "dense":
        assert row_over.any() and total > H
    if runs == "one":
        assert n_runs == -(-valid // 32)  # a run a chunk
    if runs == "own":
        assert n_runs == valid
    if runs == "across":  # the run of 40 from match 20 is three runs
        assert {(0, 20), (1, 32)} <= chunks and base[20] == base[59]
    if runs == "cut":
        assert base[valid - 1] == base[valid]


def _emit_counts(rng, M, K, kind):
    """One pair's hit counts: "mixed" about 60% zero and the others 1 to
    K (K itself among them, and one count past K and one below 0, which
    emit_plain and H3 hold to [0, K]), "zero" none, "one" a single match
    holding every hit, "full" K every match."""
    if kind == "zero":
        return np.zeros(M, np.int64)
    if kind == "one":
        c = np.zeros(M, np.int64)
        c[int(rng.integers(M))] = K
        return c
    if kind == "full":
        return np.full(M, K, np.int64)
    c = np.where(rng.uniform(size=M) < 0.6, 0, rng.integers(1, K + 1, M))
    c[rng.choice(M, 3, replace=False)] = (K, K + 5, -3)
    return c


# (M, K, counts, H, threads): H a number, or "below" / "at" / "above"
# pair 0's total.
H3_CASES = [(M, K, "mixed", H, H3_THREADS)
            for M, K in ((96, 16), (700, 48), (2048, 48), (4096, 96))
            for H in (0, 1, "below", "at", "above")] + [
    (700, 16, "zero", 1, H3_THREADS), (700, 16, "zero", "above", H3_THREADS),
    (2048, 96, "one", "below", H3_THREADS),
    (2048, 96, "one", "at", H3_THREADS),
    (2048, 96, "one", "above", H3_THREADS),
    (96, 16, "full", "at", H3_THREADS),
    (1001, 48, "mixed", "below", H3_THREADS),
    (1001, 48, "mixed", "above", H3_THREADS),
    (2048, 48, "mixed", "below", 1024), (4096, 96, "mixed", "above", 256)]


@pytest.mark.parametrize("M,K,counts,H,threads", [
    pytest.param(*case, id="-".join(map(str, case))) for case in H3_CASES])
def test_h3_places_equal_compact(M, K, counts, H, threads):
    """H3's blocks, warp scans, shuffle placement and tail split (NumPy,
    ``h3_places``) give emit_plain's outputs bit for bit on two pairs
    (the second's counts reversed): every field, the count and the
    overflow (H's, the matches' or a row's)."""
    rng = np.random.default_rng(M + K + len(counts))
    c0 = _emit_counts(rng, M, K, counts)
    counts2 = np.stack([c0, c0[::-1]])
    total0 = int(np.clip(c0, 0, K).sum())
    H = {"below": total0 // 2 + 1, "at": total0,
         "above": total0 + 37}.get(H, H)
    P = 2
    s = hk.Slots(
        quat=torch.from_numpy(rng.normal(size=(P, M, 4)).astype(np.float32)),
        t=torch.from_numpy(rng.normal(size=(P, M, K, 3)).astype(np.float32)),
        count=torch.from_numpy(counts2.astype(np.int32)),
        row_overflow=torch.from_numpy(rng.uniform(size=(P, M)) < np.array(
            [[0.0], [0.002 if counts != "zero" else 0.0]])))
    zeros = torch.zeros((P, M), dtype=torch.int64)
    m = hk.Matches(count=torch.full((P,), M, dtype=torch.int32),
                   overflow=torch.tensor([False, counts == "one"]),
                   valid=torch.ones((P, M), dtype=torch.bool), i1=zeros,
                   j1=zeros, i2=zeros, j2=zeros,
                   type_=torch.from_numpy(rng.integers(0, 3, (P, M))
                                          .astype(np.int32)))
    want = hk.emit_plain(s, m, H)
    q = torch.zeros((P, H, 4))
    t = torch.zeros((P, H, 3))
    ty = torch.zeros((P, H), dtype=torch.int32)
    valid = torch.zeros((P, H), dtype=torch.bool)
    count = torch.zeros(P, dtype=torch.int32)
    over = torch.zeros(P, dtype=torch.bool)
    for k in range(P):
        places, total = h3_places(counts2[k], H, K, threads)
        mm, hh = (torch.from_numpy(x) for x in places.T)
        n = len(places)
        q[k, :n], t[k, :n] = s.quat[k, mm], s.t[k, mm, hh]
        ty[k, :n], valid[k, :n] = m.type_[k, mm], True
        count[k] = n
        over[k] = (total > H or bool(m.overflow[k])
                   or bool(s.row_overflow[k].any()))
    got = (q, t, ty, valid, count, over)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    assert bool(over[0]) == (H < total0)  # pair 0: no row or M overflow


@pytest.mark.parametrize("B,M,density", [
    (120, 1024, 0.05), (120, 64, 0.05), (10, 1024, 0.5), (276, 2048, 0.2),
    (3, 4, 1.0), (15, 100, 0.3), (2016, 2048, 0.0005)])
def test_match_compaction_equals_compact(B, M, density):
    """H1's ranks, rows, ballots and scans (NumPy) against compact of the
    b1-major mask, with more matches than M among the cases, ranks with
    no row (B = 3) and rows of 63 words (B = 2016)."""
    rng = np.random.default_rng(B + M)
    mask = rng.uniform(size=(B, B)) < density
    src, count, over = h1_compaction(mask, M)
    c, o, valid, got = compact(torch.from_numpy(mask.reshape(-1))[None], M,
                               torch.arange(B * B)[None], batch_dims=1)
    assert (count, over) == (int(c[0]), bool(o[0]))
    np.testing.assert_array_equal(src[:count], got[0][valid[0]].numpy())
    assert over == (mask.sum() > M)


# ---------------------------------------------------------- batch rows --


def test_pair_alone_equals_its_batch_row():
    f1, f2 = face_pairs(7, 4, 16, ("plain", "nan", "zero", "none"))
    tf1, tf2 = to_port(f1), to_port(f2)
    batch = generate_hypotheses(tf1, tf2, PARAMS, HERITAGE_LIKE)
    for k in range(4):
        alone = generate_hypotheses(
            Faces(*(x[k:k + 1] for x in tf1)),
            Faces(*(x[k:k + 1] for x in tf2)), PARAMS, HERITAGE_LIKE)
        for a, b in zip(alone, batch):
            a, b = a[0], b[k]
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)


def test_cpu_calls_build_nothing():
    """The entries take the plain versions for CPU tensors: no build, no
    launch counted; another device raises."""
    f1, f2 = (to_port(a) for a in face_pairs(5, 2, 8))
    counts = (hk.BASES, hk.MATCHES, hk.SLOTS, hk.EMITS)
    kept = hk._LIBRARY._lib
    hk.bases(f1, PARAMS)
    m = hk.matches(f1, f2, PARAMS, 64)
    s = hk.slots(f1, f2, m, PARAMS, 16)
    hk.emit(s, m, 128)
    assert (hk.BASES, hk.MATCHES, hk.SLOTS, hk.EMITS) == counts
    assert hk._LIBRARY._lib is kept
    meta = Faces(*(x.to("meta") for x in f1))
    with pytest.raises(ValueError):
        hk.bases(meta, PARAMS)
    with pytest.raises(ValueError):
        hk.matches(meta, meta, PARAMS, 64)
