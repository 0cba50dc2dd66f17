"""How much the octree anchoring moves the reference algorithm (the
port's ``tools/anchor_sensitivity.py``).

The NumPy twin (``twin/twin.py``) anchors its voxel cells at the
absolute origin, as the pipeline does; the reference anchors its PCL
octrees at the cloud's bounding box (FCCF.cpp:475-479 face extraction,
:792-796 fine verify). This runs the twin with both anchorings
(``anchor="origin"`` and ``"bbox"``) over the twin-sweep families'
seeds and measures how far the choice shifts (a) face membership, (b)
the final transform and (c) success against ground truth. NumPy on the
CPU; no card.

Membership: each downsampled target point takes the face that owns its
voxel cell under each anchoring; agreement is the Rand index over the
points labelled in both partitions (the cells themselves cannot be
joined across anchorings, because the grids are shifted).

    python -m fccf_pcr_torch.evaluation.anchor_sensitivity \
        [--families office,stairs,...] [--seeds 30-39] [--json OUT.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import numpy as np
import torch

from ..config import FCCFParams
from ..io import synthetic
from ..ops import geometry
from ..twin import twin
from ..twin.families import FAMILIES


def point_labels(cloud, params, anchor):
    """The face label of each point of ``cloud`` under the octree
    ``anchor`` (-1: on no selected face)."""
    faces, _, _ = twin.face_extrate(cloud, params, anchor=anchor)
    shift = cloud.min(axis=0) if anchor == "bbox" else 0.0
    cell_to_face = {}
    for fi, f in enumerate(faces):
        for mu, _, _ in f.voxels:
            c = tuple(np.floor((np.asarray(mu, np.float64) - shift)
                               / params.face_voxel_size).astype(np.int64))
            cell_to_face[c] = fi
    keys = np.floor((cloud - shift) / params.face_voxel_size).astype(np.int64)
    return np.array([cell_to_face.get(tuple(k), -1) for k in keys],
                    dtype=np.int64)


def rand_index(a, b):
    """(Rand index, rows counted) between two labellings over the rows
    labelled in both, by pair counting on the contingency table."""
    keep = (a >= 0) & (b >= 0)
    a, b = a[keep], b[keep]
    n = len(a)
    if n < 2:
        return 1.0, n

    def c2(x):
        return x * (x - 1) // 2

    sum_ij = sum(c2(v) for v in Counter(zip(a.tolist(), b.tolist())).values())
    sum_i = sum(c2(v) for v in Counter(a.tolist()).values())
    sum_j = sum(c2(v) for v in Counter(b.tolist()).values())
    total = c2(n)
    return (total + 2 * sum_ij - sum_i - sum_j) / total, n


def _errors(T, T_ref):
    """(deg, m) of ``T`` against ``T_ref`` (float64 NumPy transforms) as
    the JAX tool's ``registration_errors`` evaluates them: the rotation
    products in float64, rounded to float32 and added in row-major order
    (XLA's), the rest in float32. Near the identity one float32 step of
    the trace moves the angle by ~0.016 deg, so the order is kept."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    prod = (T_ref[:3, :3] * T[:3, :3]).astype(np.float32).ravel()
    tr = prod[0]
    for x in prod[1:]:
        tr = tr + x  # float32 scalars
    cos = torch.clamp((torch.tensor(tr) - 1.0) / 2.0, -1.0, 1.0)
    rte = torch.linalg.norm(torch.tensor(
        (T[:3, 3] - T_ref[:3, 3]).astype(np.float32)))
    return float(geometry.degrees(torch.arccos(cos))), float(rte)


def record(family, seed, params=None):
    """One (family, seed) record: the membership Rand index of the
    target's faces under both anchorings, their face cover, and each
    anchoring's transform against the other and against ground truth
    (success: within 2 deg / 0.5 m)."""
    params = params or FCCFParams()
    cfg = FAMILIES[family]
    src, tar, T_gt = synthetic.make_pair(seed=seed, **cfg["scene"],
                                         **cfg["pair"])
    cloud_t = twin.voxel_grid_downsample(tar[np.isfinite(tar).all(1)],
                                         params.leaf_size)
    la = point_labels(cloud_t, params, "origin")
    lb = point_labels(cloud_t, params, "bbox")
    rand, n_both = rand_index(la, lb)
    T_a = twin.register_pair(src, tar, params, anchor="origin")
    T_b = twin.register_pair(src, tar, params, anchor="bbox")
    rre_ab, rte_ab = _errors(T_b, T_a)
    rre_a, rte_a = _errors(T_a, T_gt)
    rre_b, rte_b = _errors(T_b, T_gt)
    return dict(
        family=family, seed=seed, rand_index=float(rand),
        n_joint_pts=int(n_both), face_cover_origin=float((la >= 0).mean()),
        face_cover_bbox=float((lb >= 0).mean()), rre_bbox_vs_origin=rre_ab,
        rte_bbox_vs_origin=rte_ab, ok_origin=rre_a < 2.0 and rte_a < 0.5,
        ok_bbox=rre_b < 2.0 and rte_b < 0.5, rre_origin=rre_a,
        rte_origin=rte_a, rre_bbox=rre_b, rte_bbox=rte_b,
    )


def summary(family, rows):
    """One family's line: Rand index mean and least, successes under each
    anchoring, and how often the two transforms agree (1.5 deg / 0.3 m)
    where both succeed."""
    ri = [r["rand_index"] for r in rows]
    both = [r for r in rows if r["ok_origin"] and r["ok_bbox"]]
    agree = sum(r["rre_bbox_vs_origin"] < 1.5 and r["rte_bbox_vs_origin"] < 0.3
                for r in both)
    return (f"[{family}] rand_index mean={np.mean(ri):.4f} "
            f"min={np.min(ri):.4f}; ok origin="
            f"{sum(r['ok_origin'] for r in rows)}/{len(rows)} bbox="
            f"{sum(r['ok_bbox'] for r in rows)}/{len(rows)}; transform "
            f"agreement where both ok: {agree}/{len(both)}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fccf_pcr_torch.evaluation.anchor_sensitivity")
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--seeds", default="30-39", help="an inclusive range")
    ap.add_argument("--json", default=None, help="JSONL file to append to")
    args = ap.parse_args(argv)
    lo, hi = (int(x) for x in args.seeds.split("-"))
    params = FCCFParams()
    out = open(args.json, "a") if args.json else None
    try:
        for fam in args.families.split(","):
            rows = []
            for s in range(lo, hi + 1):
                rec = record(fam, s, params)
                rows.append(rec)
                print(json.dumps(rec), flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
            print(summary(fam, rows), flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
