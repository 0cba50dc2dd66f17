"""Faithful scalar NumPy twin of the reference pipeline (a copy of
``fccf_pcr_tpu/twin/twin.py`` on the port's ``config.py``, pinned to it
bit for bit by ``tests/test_torch_twin.py``).

This module reimplements ``FCCF.cpp`` stage by stage in plain NumPy with the
reference's *exact* sequential, order-dependent semantics — greedy region
growth with running averages (FCCF.cpp:536-648), greedy overlapping
clustering (:1040-1231), adaptive-floor emission, all quirks included.

Purpose (SURVEY.md §7 hard part #1): the TPU pipeline intentionally replaces
order-dependent greedy growth with order-independent label propagation;
when results diverge on a scene, this twin is the debugging oracle that
shows what the reference *would* have computed. It is also the golden for
output-level parity tests. It is NOT a performance path.

Divergences from the C++ (documented, shared with the TPU pipeline):
  - by default, voxel cells are anchored at the absolute origin, not the
    PCL octree bounding box.  ``anchor="bbox"`` switches the two octree
    stages (face_extrate FCCF.cpp:475-479, fine_verify :792-796) to
    PCL-style anchoring at the cloud's min corner, de-correlating the
    oracle from the pipeline's shared choice so anchoring-sensitivity can
    be measured (docs/PARITY.md).  ``voxel_grid_downsample`` stays
    origin-anchored in both modes because pcl::VoxelGrid itself bins at
    ``floor(p / leaf)`` — only the octrees are bbox-anchored in PCL;
  - Ceres is replaced by the same LM solve the TPU path uses (identical
    cost function, see refine/gauss_newton.py docstring).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import FCCFParams


# --------------------------------------------------------------------- util
def _angle_deg(n1, n2):
    cos = np.dot(n1, n2) / max(np.linalg.norm(n1) * np.linalg.norm(n2), 1e-20)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def _compare_plane(n1, c1, n2, c2, l, k):
    d = c1 - c2
    dist = np.linalg.norm(d)
    if dist <= 1e-12:
        return True
    dh = d / dist
    t = l / (k * dist + 1.0)
    return abs(np.dot(n1, dh)) < t and abs(np.dot(n2, dh)) < t


def _rodrigues(axis, cos_t, sin_t):
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return cos_t * np.eye(3) + (1 - cos_t) * np.outer(axis, axis) + sin_t * K


def _quat_from_R(R):
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = np.argmax(np.diag(R))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
        )
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        return np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
        )
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
    return np.array(
        [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    )


def _R_from_quat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _quat_rot(q, v):
    return _R_from_quat(q) @ v


# ------------------------------------------------------------ preprocessing
def voxel_grid_downsample(pts, leaf):
    """PCL-VoxelGrid-style: centroid per cell, (kz, ky, kx) cell order."""
    keys = np.floor(pts / leaf).astype(np.int64)
    order_keys = keys[:, [2, 1, 0]]  # z-major like PCL leaf ordering
    uniq, inv = np.unique(order_keys, axis=0, return_inverse=True)
    out = np.zeros((len(uniq), 3))
    cnt = np.zeros(len(uniq))
    np.add.at(out, inv, pts)
    np.add.at(cnt, inv, 1)
    return out / cnt[:, None]


# ------------------------------------------------------------ face extract
@dataclasses.dataclass
class Face:
    centroid: np.ndarray
    normal: np.ndarray
    point_size: float
    voxels: list  # list of (centroid, normal, count)


def face_extrate(cloud, params: FCCFParams, anchor="origin"):
    """Greedy face extraction, faithful to FCCF.cpp:470-678.

    anchor="bbox" reproduces the PCL octree's bounding-box anchoring
    (octree root box starts at the cloud's min corner, FCCF.cpp:475-479)
    instead of the absolute-origin grid shared with the TPU pipeline.
    """
    centroid_global = cloud.mean(axis=0)
    shift = cloud.min(axis=0) if anchor == "bbox" else 0.0
    keys = np.floor((cloud - shift) / params.face_voxel_size).astype(np.int64)
    order_keys = keys[:, [2, 1, 0]]
    uniq, inv = np.unique(order_keys, axis=0, return_inverse=True)

    voxels = []  # (centroid, normal, count)
    residual = []
    for u in range(len(uniq)):
        idx = np.flatnonzero(inv == u)
        if len(idx) <= params.voxel_point_threshold:
            continue
        p = cloud[idx]
        mu = p.mean(axis=0)
        q = p - mu
        cov = q.T @ q / len(p)
        lam, vec = np.linalg.eigh(cov)
        curv = lam[0] / max(lam.sum(), 1e-20)
        if curv < params.curvature_threshold:
            n = vec[:, 0]
            if np.dot(mu - centroid_global, n) >= 0:
                n = -n
            voxels.append((mu, n, len(idx)))
        else:
            residual.append(p)
    residual = np.concatenate(residual, axis=0) if residual else np.zeros((0, 3))

    # pass 1: greedy voxel -> face growth with running averages (:536-593)
    allocated = [False] * len(voxels)
    faces: list[Face] = []
    for i in range(len(voxels)):
        if allocated[i]:
            continue
        allocated[i] = True
        mu, n, c = voxels[i]
        f = Face(centroid=mu.copy(), normal=n.copy(), point_size=float(c), voxels=[voxels[i]])
        for j in range(len(voxels)):
            if allocated[j]:
                continue
            mj, nj, cj = voxels[j]
            if _angle_deg(f.normal, nj) <= params.normal_thresh1 and _compare_plane(
                f.normal, f.centroid, nj, mj, params.l1, params.k1
            ):
                f.voxels.append(voxels[j])
                allocated[j] = True
                # full weighted recompute (:570-586)
                w = np.array([v[2] for v in f.voxels], float)
                cs = np.stack([v[0] for v in f.voxels])
                ns = np.stack([v[1] for v in f.voxels])
                f.point_size = w.sum()
                f.centroid = (cs * w[:, None]).sum(0) / w.sum()
                f.normal = (ns * w[:, None]).sum(0) / w.sum()
        faces.append(f)

    # pass 2: face <-> face merge to fixpoint (:595-648)
    merged = [False] * len(faces)
    for i in range(len(faces)):
        if merged[i]:
            continue
        newadd = True
        while newadd:
            newadd = False
            for j in range(len(faces)):
                if j == i or merged[j]:
                    continue
                if _angle_deg(faces[i].normal, faces[j].normal) <= params.normal_thresh2 and _compare_plane(
                    faces[i].normal,
                    faces[i].centroid,
                    faces[j].normal,
                    faces[j].centroid,
                    params.l2,
                    params.k2,
                ):
                    newadd = True
                    merged[j] = True
                    faces[i].voxels.extend(faces[j].voxels)
                    w = np.array([v[2] for v in faces[i].voxels], float)
                    cs = np.stack([v[0] for v in faces[i].voxels])
                    ns = np.stack([v[1] for v in faces[i].voxels])
                    faces[i].point_size = w.sum()
                    faces[i].centroid = (cs * w[:, None]).sum(0) / w.sum()
                    faces[i].normal = (ns * w[:, None]).sum(0) / w.sum()

    # selection sort by voxel count desc, stable (:409-427), then top-15(+1)
    # skipping merged faces (:652-675)
    idx_sorted = sorted(
        range(len(faces)), key=lambda k: (-len(faces[k].voxels), k)
    )
    chosen = []
    thetas = []
    count = 0
    for k in idx_sorted:
        if not merged[k]:
            f = faces[k]
            chosen.append(f)
            ts = np.mean(
                [abs(_angle_deg(f.normal, v[1])) for v in f.voxels]
            )
            thetas.append(ts)
            count += 1
        if count > params.select_plane_number:
            break
    return chosen, residual, thetas


# ------------------------------------------------------------ bases
def select_base(faces, thetas, params: FCCFParams):
    bases = []
    types = []
    for i in range(len(faces)):
        for j in range(i + 1, len(faces)):
            ang = _angle_deg(faces[i].normal, faces[j].normal)
            if params.angle_min < ang < params.angle_max:
                bases.append((i, j, ang))
                ri = thetas[i] > params.rough_threshold
                rj = thetas[j] > params.rough_threshold
                types.append(1 if (ri and rj) else (0 if (not ri and not rj) else 2))
    return bases, types


# ------------------------------------------------------------ hypotheses
def computer_transform(faces1, faces2, i11, i12, i21, i22, params: FCCFParams):
    """One base match -> list of 4x4 hypotheses (quirks preserved)."""
    n1 = faces1[i11].normal
    m1 = faces1[i12].normal
    n2 = faces2[i21].normal
    m2 = faces2[i22].normal

    r1 = np.cross(n2, n1)
    r1 = r1 / max(np.linalg.norm(r1), 1e-20)
    cos1 = np.dot(n2, n1)
    sin1 = np.dot(np.cross(r1, n2), n1)
    R1 = _rodrigues(r1, cos1, sin1)
    m2r = R1 @ m2

    r2 = n1  # unnormalized, as in the reference
    denom = 1 - np.dot(m2r, r2) * np.dot(m1, r2)
    denom = denom if abs(denom) > 1e-12 else 1e-12
    cos2 = (np.dot(m2r, m1) - np.dot(m2r, r2) * np.dot(m1, r2)) / denom
    sin2 = np.dot(np.cross(r2, m2r), m1) / denom
    R2 = _rodrigues(r2, cos2, sin2)
    R = R2 @ R1

    out = []
    n1cm1 = np.cross(n1, m1)
    n1cm1 /= max(np.linalg.norm(n1cm1), 1e-20)
    thirds = [
        s
        for s in range(len(faces1))
        if s not in (i11, i12)
        and abs(np.dot(n1cm1, faces1[s].normal)) > params.third_plane_threshold
    ]
    n2cm2 = np.cross(n2, m2r)  # quirk: rotated m2
    n2cm2 /= max(np.linalg.norm(n2cm2), 1e-20)
    got = False
    if thirds:
        nt_r = [R @ f.normal for f in faces2]
        ct_r = [R @ f.centroid for f in faces2]
        for s in thirds:
            for t in range(len(faces2)):
                if t in (i21, i22):
                    continue
                if (
                    _angle_deg(faces1[s].normal, nt_r[t]) < params.third_normal_threshold
                    and abs(np.dot(n2cm2, nt_r[t])) > params.third_plane_threshold
                ):
                    got = True
                    k1 = faces1[s].normal
                    d11 = np.dot(faces1[i11].centroid, n1)
                    d12 = np.dot(faces1[i12].centroid, m1)
                    d13 = np.dot(faces1[s].centroid, k1)
                    d21 = np.dot(faces2[i21].centroid, n2)
                    d22 = np.dot(faces2[i22].centroid, m2r)  # quirk (:973)
                    d23 = np.dot(ct_r[t], nt_r[t])
                    D = np.array([d11 - d21, d12 - d22, d13 - d23])
                    A = np.stack([n1, m1, k1])
                    T = np.linalg.inv(A.T @ A) @ A.T @ D
                    M = np.eye(4)
                    M[:3, :3] = R
                    M[:3, 3] = T
                    out.append(M)
    if not got:
        w11 = faces1[i11].point_size
        w12 = faces1[i12].point_size
        w21 = faces2[i21].point_size
        w22 = faces2[i22].point_size
        sc = (faces1[i11].centroid * w11 + faces1[i12].centroid * w12) / (w11 + w12)
        tc = (faces2[i21].centroid * w21 + faces2[i22].centroid * w22) / (w21 + w22)
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = sc - R @ tc
        out.append(M)
    return out


# ------------------------------------------------------------ clustering
def transform_cluster(qts, cluster_num, params: FCCFParams):
    """Greedy overlapping clustering + adaptive-floor emission (:1040-1231).

    qts: list of (quat(4), t(3)). Returns list of representative (quat, t).
    """
    n = len(qts)
    if n <= params.cluster_count_threshold:
        if n == 0:
            return [(np.array([1.0, 0, 0, 0]), np.zeros(3))]
        return list(qts)

    px = [_quat_rot(q, np.array([1.0, 0, 0])) for q, _ in qts]
    py = [_quat_rot(q, np.array([0.0, 1, 0])) for q, _ in qts]
    allocated = [False] * n
    clusters = []
    for i in range(n - 1):  # skips the last element (:1084)
        if allocated[i]:
            continue
        members = []
        for j in range(n):
            if np.sum((qts[j][1] - qts[i][1]) ** 2) <= params.cluster_dist**2:
                if _angle_deg(px[i], px[j]) < params.cluster_angle:
                    allocated[j] = True
                    members.append(j)
        clusters.append(members)

    clusters.sort(key=len, reverse=True)  # stable in python, like :1020-1038
    reps = []
    floor = len(clusters[0])
    stop = False
    for members in clusters:
        if stop:
            break
        if len(members) >= floor:
            ts = np.stack([qts[j][1] for j in members])
            xs = np.stack([px[j] for j in members]).sum(0)
            ys = np.stack([py[j] for j in members]).sum(0)
            nt1 = xs / np.linalg.norm(xs)
            nt2 = ys / np.linalg.norm(ys)
            R = _two_axis_R(nt1, nt2)
            reps.append((_quat_from_R(R), ts.mean(0)))
            if len(reps) > cluster_num:
                break
        else:
            if len(reps) < cluster_num / 2.0:
                floor -= 1
                if floor < 2:
                    break
            else:
                stop = True
    return reps


def _two_axis_R(nt1, nt2):
    ns1 = np.array([1.0, 0, 0])
    ns2 = np.array([0.0, 1, 0])
    r1 = np.cross(ns1, nt1)
    r1 /= max(np.linalg.norm(r1), 1e-20)
    cos1 = np.dot(nt1, ns1)
    sin1 = np.dot(nt1, np.cross(r1, ns1))
    R1 = _rodrigues(r1, cos1, sin1)
    ns2r = R1 @ ns2
    r2 = nt1
    denom = 1 - np.dot(ns2r, r2) * np.dot(nt2, r2)
    denom = denom if abs(denom) > 1e-12 else 1e-12
    cos2 = (np.dot(ns2r, nt2) - np.dot(ns2r, r2) * np.dot(nt2, r2)) / denom
    sin2 = np.dot(np.cross(r2, ns2r), nt2) / denom
    R2 = _rodrigues(r2, cos2, sin2)
    return R2 @ R1


# ------------------------------------------------------------ verification
def _lm_refine(pairs, iters=50):
    """Same LM solve as refine/gauss_newton.py, in NumPy."""
    q = np.array([1.0, 0, 0, 0])
    t = np.zeros(3)
    lam = 1e-4

    def resid(q, t):
        rs = []
        for n1, p1, n2, p2, w in pairs:
            n2r = _quat_rot(q, n2)
            p2r = _quat_rot(q, p2) + t
            rs.append(w * np.cross(n1, n2r))
            rs.append([w * (np.dot(n1, p1) - np.dot(n2r, p2r))])
        return np.concatenate(rs)

    def exp_quat(v):
        th = np.linalg.norm(v)
        if th < 1e-9:
            return np.array([1.0, *(0.5 * v)])
        return np.array([np.cos(th / 2), *(np.sin(th / 2) / th * v)])

    def qmul(a, b):
        aw, ax, ay, az = a
        bw, bx, by, bz = b
        return np.array(
            [
                aw * bw - ax * bx - ay * by - az * bz,
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw,
            ]
        )

    for _ in range(iters):
        r0 = resid(q, t)
        eps = 1e-6
        J = np.zeros((len(r0), 6))
        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            qk = qmul(exp_quat(d[:3]), q)
            qk /= np.linalg.norm(qk)
            J[:, k] = (resid(qk, t + d[3:]) - r0) / eps
        JtJ = J.T @ J
        g = J.T @ r0
        delta = -np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ)) + 1e-12 * np.eye(6), g)
        qn = qmul(exp_quat(delta[:3]), q)
        qn /= np.linalg.norm(qn)
        tn = t + delta[3:]
        if np.sum(resid(qn, tn) ** 2) < np.sum(r0**2):
            q, t = qn, tn
            lam = max(lam / 3, 1e-10)
        else:
            lam = min(lam * 2, 1e8)
    M = np.eye(4)
    M[:3, :3] = _R_from_quat(q)
    M[:3, 3] = t
    return M


def quick_verify(T, faces1, faces2, params: FCCFParams):
    size1 = sum(f.point_size for f in faces1)
    size2 = sum(f.point_size for f in faces2)
    R = T[:3, :3]
    t = T[:3, 3]
    pairs = []
    score = 0.0
    for i, f1 in enumerate(faces1):
        cands = []
        for j, f2 in enumerate(faces2):
            n2t = R @ f2.normal
            c2t = R @ f2.centroid + t
            ang = _angle_deg(f1.normal, n2t)
            dist = abs(np.dot(f1.normal, f1.centroid) - np.dot(n2t, c2t))
            if ang < params.qv_angle and dist < params.qv_dist:
                cands.append(j)
        if not cands:
            continue
        best, best_score, best_imp = 0, 0.0, 0.0
        for j in cands:
            mn = min(f1.point_size, faces2[j].point_size)
            mx = max(f1.point_size, faces2[j].point_size)
            if mn / mx > best_score:
                best_score = mn / mx
                best_imp = 2 * mn / (size1 + size2)
                best = j
        score += best_imp
        pairs.append(
            (
                f1.normal,
                f1.centroid,
                R @ faces2[best].normal,
                R @ faces2[best].centroid + t,
                best_imp,
            )
        )
    T_out = T.copy()
    if len(pairs) >= params.required_optimize:
        dT = _lm_refine(pairs)
        T_out = dT @ T
    return T_out, score


def fine_verify(T, src_res, tar_res, params: FCCFParams, anchor="origin"):
    R = T[:3, :3]
    t = T[:3, 3]
    tar_t = tar_res @ R.T + t
    fused = np.concatenate([src_res, tar_t])
    labels = np.concatenate([np.zeros(len(src_res)), np.ones(len(tar_t))])
    if len(fused) == 0:
        return 0.0
    # anchor="bbox": PCL octree over the fused cloud (FCCF.cpp:792-796)
    # starts its root box at the fused cloud's min corner.
    shift = fused.min(axis=0) if anchor == "bbox" else 0.0
    keys = np.floor((fused - shift) / params.fine_voxel).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    s_cnt = np.zeros(len(uniq))
    t_cnt = np.zeros(len(uniq))
    np.add.at(s_cnt, inv, labels == 0)
    np.add.at(t_cnt, inv, labels == 1)
    both = (s_cnt >= 1) & (t_cnt >= 1)
    mn = np.minimum(s_cnt, t_cnt)
    mx = np.maximum(s_cnt, t_cnt)
    sim = np.sum(np.where(both, (s_cnt + t_cnt) * mn / np.maximum(mx, 1), 0.0))
    return float(sim / len(fused))


# ------------------------------------------------------------ driver
def register_pair(src_pts, tar_pts, params: FCCFParams, anchor="origin"):
    """Faithful driver (computer_transform_guess + main's arg swap):
    returns T mapping src -> tar.  anchor="bbox" switches the octree
    stages to PCL bounding-box anchoring (see module docstring)."""
    cloud1 = voxel_grid_downsample(tar_pts[np.isfinite(tar_pts).all(1)], params.leaf_size)
    cloud2 = voxel_grid_downsample(src_pts[np.isfinite(src_pts).all(1)], params.leaf_size)

    faces1, res1, th1 = face_extrate(cloud1, params, anchor=anchor)
    faces2, res2, th2 = face_extrate(cloud2, params, anchor=anchor)
    bases1, types1 = select_base(faces1, th1, params)
    bases2, types2 = select_base(faces2, th2, params)

    hyp = [[], [], []]
    for b1, (i1, j1, a1) in enumerate(bases1):
        for b2, (i2, j2, a2) in enumerate(bases2):
            if abs(a1 - a2) < params.angle_same and types1[b1] == types2[b2]:
                hyp[types1[b1]].extend(
                    computer_transform(faces1, faces2, i1, j1, i2, j2, params)
                )
    total = sum(len(h) for h in hyp)

    reps_scored = [[], [], []]
    s1_sum = 0.0
    s2_sum = 0.0
    for ty in range(3):
        qts = [(_quat_from_R(M[:3, :3]), M[:3, 3].copy()) for M in hyp[ty]]
        cluster_num = int(params.select_cluster_number * len(qts) / total) if total else 0
        reps = transform_cluster(qts, cluster_num, params)
        scored = []
        for q, t in reps:
            M = np.eye(4)
            M[:3, :3] = _R_from_quat(q)
            M[:3, 3] = t
            M2, s = quick_verify(M, faces1, faces2, params)
            scored.append([M2, s, 0.0])
        scored.sort(key=lambda x: -x[1])  # stable desc like score_range
        for c in scored[: int(params.fine_verify_number)]:
            c[2] = fine_verify(c[0], res1, res2, params, anchor=anchor)
            s1_sum += c[1]
            s2_sum += c[2]
        reps_scored[ty] = scored

    best_per_type = []
    best_best = 0.0
    for ty in range(3):
        best_score = 0.0
        best_M = np.eye(4)
        for M, s, f in reps_scored[ty][: int(params.fine_verify_number)]:
            comb = (s / s1_sum if s1_sum > 0 else 0.0) + (
                f / s2_sum if s2_sum > 0 else 0.0
            )
            if comb > best_score:
                best_score = comb
                best_M = M
        best_per_type.append((best_M, best_score))
        best_best = max(best_best, best_score)

    kept = [(M, s) for M, s in best_per_type if s > 0.8 * best_best]
    if not kept:
        return np.eye(4)
    ssum = sum(s for _, s in kept)
    tx = sum(M[:3, 3] * (s / ssum) for M, s in kept)
    xs = sum(_quat_rot(_quat_from_R(M[:3, :3]), np.array([1.0, 0, 0])) * (s / ssum) for M, s in kept)
    ys = sum(_quat_rot(_quat_from_R(M[:3, :3]), np.array([0.0, 1, 0])) * (s / ssum) for M, s in kept)
    R = _two_axis_R(xs / np.linalg.norm(xs), ys / np.linalg.norm(ys))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = tx
    return T
