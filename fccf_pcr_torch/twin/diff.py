"""Face-membership diff: greedy growth (twin) vs label propagation (the
port's pipeline) (port of ``fccf_pcr_tpu/twin/diff.py``).

The one deliberate semantic divergence from the reference is face growth:
the reference grows faces greedily against running averages
(FCCF.cpp:536-648, order-dependent); the pipeline computes connected
components of the symmetric predicate graph. This tool measures how much
the resulting voxel->face memberships differ on a given cloud.

Voxel identity joins on the absolute cell index floor(centroid / size):
both implementations anchor voxels absolutely, so cells match exactly.
The twin runs in NumPy on the host; the pipeline side runs the port's
``voxel_stats`` + ``faces_from_voxels`` on ``device`` (the card by
default, where label propagation is the propagation kernel).

Metrics returned by :func:`face_membership_diff`:
  n_twin / n_pipe     gated (planar) voxels in each implementation
  n_common            cells present and selected (top-16 face) in both
  pair_agreement      Rand index over common cells: fraction of cell pairs
                      on which the two partitions agree (co-members in both
                      or separated in both) - 1.0 = identical partitions
  matched_fraction    fraction of common cells whose twin face maps to the
                      same pipeline face under greedy size-weighted matching
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Capacities, FCCFParams
from ..features.faces import faces_from_voxels
from ..io.synthetic import pad_points
from ..ops.voxelize import voxel_stats
from ..pipeline.register import resolve_device
from . import twin


def _cell(p, size):
    return tuple(np.floor(np.asarray(p, np.float64) / size).astype(np.int64))


def _twin_membership(cloud, params: FCCFParams):
    """cell -> twin face index (top-16 chosen faces only)."""
    faces, _, _ = twin.face_extrate(cloud, params)
    out = {}
    for fi, f in enumerate(faces):
        for mu, _, _ in f.voxels:
            out[_cell(mu, params.face_voxel_size)] = fi
    return out


def _pipeline_membership(cloud, params: FCCFParams, caps: Capacities,
                         device="cuda"):
    """cell -> pipeline face row (top-16 selected faces only), computed
    on ``device``."""
    dev = resolve_device(device)
    pts, mask = pad_points(cloud, caps.max_points)
    vs, sorted_pts, pv = voxel_stats(
        torch.as_tensor(pts, device=dev), torch.as_tensor(mask, device=dev),
        params.face_voxel_size, caps.max_voxels,
    )
    _, _, _, labels = faces_from_voxels(
        vs, sorted_pts, pv, params, caps, with_labels=True
    )
    centroid = vs.centroid.cpu().numpy()
    final_label, vvalid, order, fvalid = (x.cpu().numpy() for x in labels)
    row_of_label = {int(order[k]): k for k in range(len(order)) if fvalid[k]}
    out = {}
    for slot in np.flatnonzero(vvalid):
        row = row_of_label.get(int(final_label[slot]))
        if row is not None:
            out[_cell(centroid[slot], params.face_voxel_size)] = row
    return out


def face_membership_diff(cloud, params: FCCFParams, caps: Capacities,
                         device="cuda") -> dict:
    """Quantify greedy-vs-label-prop membership divergence on one cloud;
    the pipeline side runs on ``device`` (``resolve_device``)."""
    mt = _twin_membership(np.asarray(cloud, np.float64), params)
    mp = _pipeline_membership(np.asarray(cloud, np.float32), params, caps,
                              device)
    common = sorted(set(mt) & set(mp))
    n = len(common)
    res = {
        "n_twin": len(mt),
        "n_pipe": len(mp),
        "n_common": n,
        "pair_agreement": 1.0,
        "matched_fraction": 1.0,
    }
    if n < 2:
        return res

    lt = np.array([mt[c] for c in common])
    lp = np.array([mp[c] for c in common])

    # Rand index over all cell pairs (n <= a few thousand on test scenes).
    same_t = lt[:, None] == lt[None, :]
    same_p = lp[:, None] == lp[None, :]
    iu = np.triu_indices(n, k=1)
    res["pair_agreement"] = float(np.mean(same_t[iu] == same_p[iu]))

    # Greedy size-ordered matching of twin faces to pipeline faces, then the
    # fraction of cells whose assignment survives the mapping.
    pairs, counts = np.unique(
        np.stack([lt, lp], axis=1), axis=0, return_counts=True
    )
    used_t, used_p, mapping = set(), set(), {}
    for k in np.argsort(-counts):
        a, b = int(pairs[k][0]), int(pairs[k][1])
        if a not in used_t and b not in used_p:
            mapping[a] = b
            used_t.add(a)
            used_p.add(b)
    matched = sum(
        1 for i in range(n) if mapping.get(int(lt[i])) == int(lp[i])
    )
    res["matched_fraction"] = matched / n
    return res


__all__ = ["face_membership_diff"]
