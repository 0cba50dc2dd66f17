"""Unrolled 6x6 SPD solve (port of ``fccf_pcr_tpu/ops/linalg6.py``): the
LM refinement solves one damped normal-equations system per candidate per
iteration, as elementwise ops batched over the candidates."""

from __future__ import annotations

import torch

_EPS = 1e-20


def solve_spd6(A, b):
    """Solve A x = b for symmetric positive-definite 6x6 A (batched).

    A: (..., 6, 6), b: (..., 6). Unrolled Cholesky + forward/back
    substitution; singular/indefinite inputs are guarded with a tiny
    diagonal floor (callers add LM damping anyway).
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(s, min=_EPS))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv

    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]

    return torch.stack(x, dim=-1)
