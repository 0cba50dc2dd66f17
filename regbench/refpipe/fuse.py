"""Score-weighted fusion of the per-type best transforms (port of
``fccf_pcr_tpu/fuse/fuse.py``; ``weight_normal`` FCCF.cpp:1253-1289 and
``fuse_answer`` :1291-1368)."""

from __future__ import annotations

import torch

from . import geometry
from .batch import constant


def fuse_transforms(quat, t, score, valid):
    """quat (..., K, 4), t (..., K, 3), score (..., K), valid (..., K) ->
    fused (..., 4, 4), one transform for each set of the leading batch
    dims.

    Translation is the score-weighted mean; rotation is rebuilt (two
    Rodrigues steps) from the weighted, normalized means of the rotated
    x/y axes. A fully degenerate set yields identity. The weighted sums
    are elementwise products summed over K, which round alike for every
    batch size.
    """
    dt = t.dtype
    dev = t.device
    w = torch.where(valid, score, 0.0)
    s = torch.sum(w, dim=-1)
    w = (w / torch.clamp(s, min=1e-20)[..., None])[..., None]
    mean_t = torch.sum(w * t, dim=-2)
    xhat = constant((1.0, 0.0, 0.0), dt, dev).expand(t.shape)
    yhat = constant((0.0, 1.0, 0.0), dt, dev).expand(t.shape)
    x = geometry.quat_rotate(quat, xhat)
    y = geometry.quat_rotate(quat, yhat)
    nt1 = geometry.normalize(torch.sum(w * x, dim=-2))
    nt2 = geometry.normalize(torch.sum(w * y, dim=-2))
    R = geometry.rotation_from_two_axes(nt1, nt2)
    T = geometry.make_transform(R, mean_t)
    return torch.where((s > 0)[..., None, None], T,
                       torch.eye(4, dtype=dt, device=dev))
