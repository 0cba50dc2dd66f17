"""The hot co-sorts (port of ``fccf_pcr_tpu/ops/sorting.py``).

``cosort`` is a stable sort by a lexicographic tuple of integer keys plus
one gather per payload — what ``jax.lax.sort(..., is_stable=True)`` does
with payloads riding the sort. Several keys are sorted least significant
first, each pass stable, so the composite order is lexicographic.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function


def cosort(keys, payloads=(), dim: int = -1):
    """Sort ``(*keys, *payloads)`` by the lexicographic ``keys`` along
    ``dim``; returns the same tuple, sorted. Always stable."""
    with record_function("cosort"):
        keys = tuple(keys)
        perm = None
        for k in reversed(keys):
            kk = k if perm is None else torch.gather(k, dim, perm)
            _, p = torch.sort(kk, dim=dim, stable=True)
            perm = p if perm is None else torch.gather(perm, dim, p)
        return tuple(torch.gather(x, dim, perm) for x in (*keys, *payloads))
