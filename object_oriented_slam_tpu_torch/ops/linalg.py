"""Closed-form small linear algebra (port of ``ops/linalg.py``).

The adjugate inverse and the fully unrolled Cholesky solve keep the JAX
package's exact operation sequence, so degenerate inputs give the same
NaN/inf pattern (the LM's ``du_ok`` gate depends on it).  Run eagerly on
a GPU, the unrolled solve is several hundred tiny launches per call; it
is kept in this form until it is fused into a kernel.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-30


def det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


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


def solve3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cramer solve of [..., 3, 3] @ x = [..., 3]."""
    return (inv3(m) * v[..., None, :]).sum(-1)


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


def inv4(m: torch.Tensor) -> torch.Tensor:
    """Cofactor inverse of [..., 4, 4] (expansion by 2x2 minors)."""
    m00, m01, m02, m03 = (m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3])
    m10, m11, m12, m13 = (m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3])
    m20, m21, m22, m23 = (m[..., 2, 0], m[..., 2, 1], m[..., 2, 2], m[..., 2, 3])
    m30, m31, m32, m33 = (m[..., 3, 0], m[..., 3, 1], m[..., 3, 2], m[..., 3, 3])

    s0 = m00 * m11 - m10 * m01
    s1 = m00 * m12 - m10 * m02
    s2 = m00 * m13 - m10 * m03
    s3 = m01 * m12 - m11 * m02
    s4 = m01 * m13 - m11 * m03
    s5 = m02 * m13 - m12 * m03

    c5 = m22 * m33 - m32 * m23
    c4 = m21 * m33 - m31 * m23
    c3 = m21 * m32 - m31 * m22
    c2 = m20 * m33 - m30 * m23
    c1 = m20 * m32 - m30 * m22
    c0 = m20 * m31 - m30 * m21

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    invdet = 1.0 / (det + torch.where(det == 0, _EPS, 0.0))

    r00 = (m11 * c5 - m12 * c4 + m13 * c3) * invdet
    r01 = (-m01 * c5 + m02 * c4 - m03 * c3) * invdet
    r02 = (m31 * s5 - m32 * s4 + m33 * s3) * invdet
    r03 = (-m21 * s5 + m22 * s4 - m23 * s3) * invdet
    r10 = (-m10 * c5 + m12 * c2 - m13 * c1) * invdet
    r11 = (m00 * c5 - m02 * c2 + m03 * c1) * invdet
    r12 = (-m30 * s5 + m32 * s2 - m33 * s1) * invdet
    r13 = (m20 * s5 - m22 * s2 + m23 * s1) * invdet
    r20 = (m10 * c4 - m11 * c2 + m13 * c0) * invdet
    r21 = (-m00 * c4 + m01 * c2 - m03 * c0) * invdet
    r22 = (m30 * s4 - m31 * s2 + m33 * s0) * invdet
    r23 = (-m20 * s4 + m21 * s2 - m23 * s0) * invdet
    r30 = (-m10 * c3 + m11 * c1 - m12 * c0) * invdet
    r31 = (m00 * c3 - m01 * c1 + m02 * c0) * invdet
    r32 = (-m30 * s3 + m31 * s1 - m32 * s0) * invdet
    r33 = (m20 * s3 - m21 * s1 + m22 * s0) * invdet

    row0 = torch.stack([r00, r01, r02, r03], dim=-1)
    row1 = torch.stack([r10, r11, r12, r13], dim=-1)
    row2 = torch.stack([r20, r21, r22, r23], dim=-1)
    row3 = torch.stack([r30, r31, r32, r33], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, written out (no library call, so
    the CPU and the card round alike)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def eigh3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [..., 3, 3] matrices.

    Returns ``(vals [..., 3] ascending, vecs [..., 3, 3] columns)`` like
    ``torch.linalg.eigh`` (eigenvector signs arbitrary, as there): Smith's
    trigonometric solution of the characteristic cubic for the
    eigenvalues, then cross-product null-space extraction for the outer
    eigenvectors (the best-separated ones) with the middle one completed
    by orthogonality.  Elementwise, so it batches over any leading axes.

    Degenerate handling: near-isotropic matrices (all eigenvalues equal)
    return identity vectors; a repeated outer pair falls back to an
    explicit orthogonal complement, so the returned basis is always
    right-handed-orthonormal to f32 roundoff.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    dt = A.dtype
    tiny = 1e-20 if dt == torch.float64 else 1e-12

    q = (a00 + a11 + a22) / 3.0
    p2 = ((a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    scale = torch.clamp_min(p, tiny)
    b00, b11, b22 = (a00 - q) / scale, (a11 - q) / scale, (a22 - q) / scale
    b01, b02, b12 = a01 / scale, a02 / scale, a12 / scale
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    phi = torch.acos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # eigenvectors on the SCALE-NORMALIZED matrix B = (A - q I)/p, whose
    # eigenvalues (lam - q)/p are O(1): cross-product norms then measure
    # RELATIVE eigen-gaps, making the degeneracy thresholds below
    # invariant to the overall magnitude of A
    B = torch.stack([
        torch.stack([b00, b01, b02], dim=-1),
        torch.stack([b01, b11, b12], dim=-1),
        torch.stack([b02, b12, b22], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=dt, device=A.device)

    def null_vec(beta):
        """Largest row-cross of (B - beta I): a null vector whose norm^2
        grows with the eigen-gap (robustness score)."""
        M = B - beta[..., None, None] * eye
        c0 = cross(M[..., 0, :], M[..., 1, :])
        c1 = cross(M[..., 0, :], M[..., 2, :])
        c2 = cross(M[..., 1, :], M[..., 2, :])
        n0 = (c0 * c0).sum(-1)
        n1 = (c1 * c1).sum(-1)
        n2 = (c2 * c2).sum(-1)
        best01 = torch.where((n0 >= n1)[..., None], c0, c1)
        nb01 = torch.maximum(n0, n1)
        s = torch.maximum(nb01, n2)
        best = torch.where((nb01 >= n2)[..., None], best01, c2)
        return best / torch.sqrt(torch.clamp_min(s, tiny))[..., None], s

    vhi, shi = null_vec((l2 - q) / scale)
    vlo, slo = null_vec((l0 - q) / scale)

    # the better-separated outer eigenvalue yields the trustworthy
    # vector; the other is re-orthogonalized against it (or replaced by
    # an explicit orthogonal complement when its pair is repeated)
    hi_primary = (shi >= slo)[..., None]
    base = torch.where(hi_primary, vhi, vlo)
    other = torch.where(hi_primary, vlo, vhi)
    other = other - (other * base).sum(-1, keepdim=True) * base
    on2 = (other * other).sum(-1)
    # e_x where base is not along x, else e_y (built on the device: a
    # constant copied from the host would make the host wait for the stream)
    off_x = base[..., 0:1].abs() < 0.9
    ax = torch.cat([off_x.to(dt), (~off_x).to(dt),
                    torch.zeros_like(off_x, dtype=dt)], dim=-1)
    alt = cross(base, ax)
    alt = alt / torch.sqrt(torch.clamp_min((alt * alt).sum(-1),
                                           tiny))[..., None]
    degen = (torch.minimum(shi, slo) <= 1e-12) | (on2 <= 1e-12)
    other = torch.where(degen[..., None], alt,
                        other / torch.sqrt(torch.clamp_min(on2,
                                                           tiny))[..., None])
    v2 = torch.where(hi_primary, base, other)
    v0 = torch.where(hi_primary, other, base)
    v1 = cross(v2, v0)

    vecs = torch.stack([v0, v1, v2], dim=-1)
    # isotropic: eigenvalues all q, any orthonormal basis; use identity
    iso = p2 <= 1e-12 * torch.clamp_min(q * q, tiny)
    vecs = torch.where(iso[..., None, None], eye, vecs)
    # Rayleigh-quotient polish: the trigonometric roots lose ~sqrt(eps)
    # digits near repeated eigenvalues (acos at +-1), but v^T A v is
    # exact-to-roundoff for ANY unit vector of the (possibly degenerate)
    # eigenspace
    vals = torch.einsum("...ji,...jk,...ki->...i", vecs, A, vecs)
    return vals, vecs
