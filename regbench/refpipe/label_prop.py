"""Connected-component min labels of the voxel affinity graph: the
plain PyTorch version of label propagation (the affinity matrix built
with (V, 3) x (3, V) products, Jacobi sweeps of min-label propagation,
each followed by path halving), on any device. A frozen copy of
``label_propagate_plain`` in ``fccf_pcr_torch/ops/label_prop.py``, whose
labels the propagation kernel K1 / P1 reaches too: labels[i] is the
minimum valid slot index of i's component, invalid slots hold ``_BIG``.
"""

from __future__ import annotations

import torch

from .geometry import cos_deg, normalize
from .precision import matmul

_BIG = 2**30


def gather_rows(tbl, idx):
    """out[..., i] = tbl[..., clamp(idx[..., i], 0, V - 1)]."""
    V = tbl.shape[-1]
    return torch.gather(tbl, -1, torch.clamp(idx, 0, V - 1).long())


def pairwise_affinity(normal, centroid, valid, angle_thresh_deg, l, k):
    """(..., V, V) boolean affinity from compare_normal & compare_plane,
    built with (V, 3) x (3, V) matmuls (``faces.py:58-82``)."""
    nh = normalize(normal)
    cosmat = matmul(nh, nh.mT)
    ok_normal = cosmat >= cos_deg(angle_thresh_deg)

    c2 = torch.sum(centroid * centroid, dim=-1)
    d2 = c2[..., :, None] + c2[..., None, :] - 2.0 * matmul(centroid, centroid.mT)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    ndotc = torch.sum(normal * centroid, dim=-1)
    m1 = ndotc[..., :, None] - matmul(normal, centroid.mT)
    m2 = matmul(centroid, normal.mT) - ndotc[..., None, :]
    t = l / (k * dist + 1.0)
    ok_plane = (torch.abs(m1) < t * dist) & (torch.abs(m2) < t * dist)
    ok_plane = torch.where(dist > 1e-9, ok_plane, True)

    vv = valid[..., :, None] & valid[..., None, :]
    return vv & ok_normal & ok_plane


def pointer_jump(labels, V, rounds: int = 8):
    """Path halving, batched over leading dims:
    labels <- min(labels, labels[labels]) ``rounds`` times, reads clamped
    to the row of V slots."""
    assert labels.shape[-1] == V
    for _ in range(rounds):
        labels = torch.minimum(labels, gather_rows(labels, labels))
    return labels


def _label_propagate(affinity, valid, max_iters):
    """Min-label propagation (Jacobi sweeps over the affinity matrix, each
    followed by 8 path-halving rounds) until a sweep changes nothing, or
    ``max_iters`` sweeps. Batched over leading dims; a lane at its
    fixpoint is unchanged by further sweeps, so the batch is exact."""
    V = affinity.shape[-1]
    big = torch.full_like(valid, _BIG, dtype=torch.int32)
    ar = torch.arange(V, dtype=torch.int32, device=valid.device)
    labels = torch.where(valid, ar.expand(valid.shape), big)
    for _ in range(max_iters):
        neigh = torch.amin(
            torch.where(affinity, labels[..., None, :], _BIG), dim=-1
        )
        new = torch.minimum(labels, neigh)
        new = torch.where(valid, pointer_jump(new, V),
                          big)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def label_propagate_plain(normal, centroid, valid, angle_thresh_deg, l, k,
                          max_iters: int = 32):
    """The plain PyTorch version (any device): (..., V) int32 labels."""
    aff = pairwise_affinity(normal, centroid, valid, angle_thresh_deg, l, k)
    return _label_propagate(aff, valid, max_iters)


def label_propagate(normal, centroid, valid, angle_thresh_deg, l, k,
                    bound=None, max_iters: int = 32):
    """Component-min labels: normal, centroid (V, 3) or (P, V, 3), valid
    (V,) / (P, V). ``bound`` is ignored (every valid slot lies below
    it)."""
    squeeze = normal.dim() == 2
    if squeeze:
        normal, centroid, valid = normal[None], centroid[None], valid[None]
    labels = label_propagate_plain(normal, centroid, valid, angle_thresh_deg,
                                   l, k, max_iters)
    return labels[0] if squeeze else labels
