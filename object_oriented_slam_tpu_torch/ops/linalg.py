"""Closed-form small linear algebra (port of ``ops/linalg.py``).

The adjugate inverse and the fully unrolled Cholesky solve keep the JAX
package's exact operation sequence, so degenerate inputs give the same
NaN/inf pattern (the LM's ``du_ok`` gate depends on it).  Run eagerly on
a GPU, the unrolled solve is several hundred tiny launches per call; it
is kept in this form until it is fused into a kernel.
"""
from __future__ import annotations

import torch

_EPS = 1e-30


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of [..., 3, 3]."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ], dim=-2)
    det = det[..., None, None]
    return adj / (det + torch.where(det == 0, _EPS, 0.0))


def chol_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b for small static n via fully unrolled Cholesky.

    A [..., n, n], b [..., n] -> x [..., n].  A must be symmetric positive
    definite (H + lambda*I always is).
    """
    n = A.shape[-1]
    eps = 1e-20
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, eps))
            else:
                L[i][j] = s / L[j][j]
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
