"""Capacity padding for the fixed-shape pipeline.

Every stage consumes (capacity, 3) masked arrays; this is the one
helper that adapts an arbitrary-size cloud to that contract. It lives
here (not in io/synthetic.py, which only generates test fixtures)
because the production paths — CLI, sweeps, bench — all use it on
real data. The native batch loader (csrc/ply_reader.cpp) implements the
identical subsample bit-exactly; tests/test_io.py pins the parity.
"""

from __future__ import annotations

import numpy as np


def pad_points(pts, capacity):
    """Pad (M,3) points to (capacity,3) + mask. Overflow is subsampled
    deterministically (every k-th point)."""
    m = pts.shape[0]
    if m > capacity:
        idx = np.linspace(0, m - 1, capacity).astype(np.int64)
        pts = pts[idx]
        m = capacity
    out = np.zeros((capacity, 3), np.float32)
    out[:m] = pts
    mask = np.zeros((capacity,), bool)
    mask[:m] = True
    return out, mask
