"""Score-weighted fusion of the per-type best transforms (port of
``fccf_pcr_tpu/fuse/fuse.py``; ``weight_normal`` FCCF.cpp:1253-1289 and
``fuse_answer`` :1291-1368)."""

from __future__ import annotations

import torch

from ..ops import geometry


def fuse_transforms(quat, t, score, valid):
    """quat (K, 4), t (K, 3), score (K,), valid (K,) -> fused 4x4.

    Translation is the score-weighted mean; rotation is rebuilt (two
    Rodrigues steps) from the weighted, normalized means of the rotated
    x/y axes. A fully degenerate set yields identity.
    """
    K = quat.shape[0]
    dt = t.dtype
    dev = t.device
    w = torch.where(valid, score, 0.0)
    s = torch.sum(w)
    w = w / torch.clamp(s, min=1e-20)
    mean_t = w @ t
    xhat = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev).expand(K, 3)
    yhat = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev).expand(K, 3)
    x = geometry.quat_rotate(quat, xhat)
    y = geometry.quat_rotate(quat, yhat)
    nt1 = geometry.normalize(w @ x)
    nt2 = geometry.normalize(w @ y)
    R = geometry.rotation_from_two_axes(nt1, nt2)
    T = geometry.make_transform(R, mean_t)
    return torch.where(s > 0, T, torch.eye(4, dtype=dt, device=dev))
