"""Row-wise gathers, scatters and sums over leading batch dims, and
constants made once on a device.

The port's stages take a leading pair axis (and, inside a stage, other
lane axes such as the three hypothesis types) where the JAX package
writes one pair and ``jax.vmap``s it. ``take`` and ``scatter_unique`` are
the batched forms of ``x[idx]`` and of a scatter of unique indices, per
row. A row of a batch must round as it does alone, but a library's
batched matrix product (cuBLAS, a CPU BLAS) picks its algorithm, and so
its order of additions, by the batch size: ``fold_sum`` and
``small_matmul`` add in an order fixed by the shape of one row, with
elementwise operations only.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def constant(values, dtype, device):
    """A small constant tensor (``values`` a tuple, nested for more dims)
    on ``device``, made once a process: a tensor made from host values is
    a copy to the card that the host waits for. Callers must not write to
    it."""
    return torch.tensor(values, dtype=dtype, device=device)


def take(x, idx):
    """``x[..., idx[..., s], ...]``: rows of ``x`` picked along the axis
    that follows idx's leading dims. ``x`` is (*lead, n, *tail), ``idx``
    is (*lead, S) of indices in [0, n); returns (*lead, S, *tail)."""
    d = idx.dim() - 1
    tail = tuple(x.shape[d + 1:])
    i = idx.reshape(tuple(idx.shape) + (1,) * len(tail))
    return torch.gather(x, d, i.expand(tuple(idx.shape) + tail))


def scatter_unique(size, dest, values):
    """out[..., dest[..., r]] = values[..., r] along the last axis, for
    dest unique below ``size`` within a row, 0 elsewhere; entries aimed at
    ``size`` land in a dump slot that is sliced off, so the result is
    deterministic on every device."""
    out = torch.zeros(tuple(dest.shape[:-1]) + (size + 1,), dtype=values.dtype,
                      device=values.device)
    out.scatter_(-1, dest.long(), values)
    return out[..., :size]


def fold_sum(x, dim):
    """Sum over ``dim`` as a fixed pairwise tree: the first half of the
    axis plus the second, repeated (an odd last entry is carried along),
    with elementwise adds only, so each sum rounds alike in any batch and
    on any device."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        head = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        x = head if n % 2 == 0 else torch.cat([head, x.narrow(dim, 2 * h, 1)],
                                              dim)
    return x.squeeze(dim)


def small_matmul(a, b):
    """``a @ b`` for an inner dim of a few entries (3 or 4), as the
    elementwise products summed in index order: ((a0 b0 + a1 b1) + a2 b2)
    ..., the same rounding for every batch size and on every device."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out
