"""Scans along long rows: the integer scans (S1's plain versions) and
the float32 base-16 blocked prefix sum in the association of XLA's CPU
cumsum (S2's plain version), on any device. A frozen copy of the plain
versions in ``fccf_pcr_torch/ops/scan.py``."""

from __future__ import annotations

import torch

SUM, MAX, MIN_REVERSED = 0, 1, 2


def int_scan_plain(x, op):
    """S1's plain version along the last dim: ``op`` SUM, MAX or
    MIN_REVERSED."""
    if op == SUM:
        return torch.cumsum(x, dim=-1)
    if op == MAX:
        return torch.cummax(x, dim=-1).values
    return torch.flip(torch.cummin(torch.flip(x, dims=[-1]), dim=-1).values,
                      dims=[-1])


def _prefix_sum0(x):
    """The blocked prefix sum along dim 0 (S2's plain version)."""
    m = x.shape[0]
    if m <= 16:
        cols = [x[0] if m == 1 else x[0] + 0.0]
        for c in range(1, m):
            cols.append(cols[-1] + x[c])
        return torch.stack(cols)
    rows = -(-m // 16)
    pad = x.new_zeros((rows * 16 - m,) + tuple(x.shape[1:]))
    X = torch.cat([x, pad]).reshape((rows, 16) + tuple(x.shape[1:]))
    cols = [X[:, 0] + 0.0]
    for c in range(1, 16):
        cols.append(cols[-1] + X[:, c])
    P = torch.stack(cols, dim=1)
    inc = _prefix_sum0(P[:, 15])
    exc = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    return (P + exc[:, None]).reshape((rows * 16,) + tuple(x.shape[1:]))[:m]


def prefix_sum_plain(x, dim=0):
    """S2's plain version along ``dim`` (any device)."""
    d = dim % x.dim()
    return _prefix_sum0(x.movedim(d, 0)).movedim(0, d)


def leaf_columns(px, py, pz, m_s, face_first):
    """The voxelization's leaf columns (..., n, 4) from the sorted anchored
    coordinates px, py, pz (float32) and flags m_s, face_first (bool), all
    (..., n): ``[px w, py w, pz w, ff]``, w = float(m_s) and ff =
    float(face_first & m_s) (a product by w, not a select)."""
    w = m_s.to(px.dtype)
    ff = (face_first & m_s).to(px.dtype)
    return torch.cat([torch.stack([px, py, pz], dim=-1) * w[..., None],
                      ff[..., None]], dim=-1)


def moment_columns(p, mask):
    """The voxelization's moment columns (..., n, 10) from p (..., n, 3)
    float32 and mask (..., n) bool: ``[x, y, z, xx, yy, zz, xy, xz, yz,
    float(mask)]``, the products in ``ops/voxelize.py::_outer6``'s order."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    outer6 = torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)
    return torch.cat([p, outer6, mask.to(p.dtype)[..., None]], dim=-1)


def leaf_sums_plain(px, py, pz, m_s, face_first):
    """``leaf_prefix_sums``' plain version (any device)."""
    return prefix_sum_plain(leaf_columns(px, py, pz, m_s, face_first), -2)


def moment_sums_plain(p, mask):
    """``moment_prefix_sums``' plain version (any device)."""
    return prefix_sum_plain(moment_columns(p, mask), -2)


def cumsum(x):
    """Inclusive prefix sum along the last dim, int64 out."""
    return int_scan_plain(x, SUM)


def cummax(x):
    """Running max along the last dim."""
    return int_scan_plain(x, MAX)




prefix_sum = prefix_sum_plain
leaf_prefix_sums = leaf_sums_plain
moment_prefix_sums = moment_sums_plain
