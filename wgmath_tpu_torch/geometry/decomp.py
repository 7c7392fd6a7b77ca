"""Batched small-matrix decompositions: LU, QR, Cholesky, symmetric eigen,
SVD (counterpart of ``wgmath_tpu/geometry/decomp.py``, the reference's
``lu.rs``, ``qr{2,3,4}.rs``, ``cholesky.rs``, ``eig{2,3,4}.rs``,
``svd2.rs`` / ``svd3.rs``).

One implementation for n = 2, 3, 4, over any leading batch axes, so a
million tiny factorizations are a fixed sequence of elementwise tensor ops
on the whole batch. Every routine is fixed-iteration and branch-free
(``torch.where``), as in the JAX package, and follows its expressions term
for term. The JAX package's ``x.at[...].set(...)`` become out-of-place
updates here, or writes into a fresh clone. The products and sums of the
matrix-vector steps are written out, so no library matrix product (which
may round through TF32 on the card) takes part. Plain tensor code: the
JAX package has no kernel here either.
"""

from __future__ import annotations

import functools

import torch

from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)
from wgmath_tpu_torch.geometry.quat import cross

# ---------------------------------------------------------------------------
# LU with partial pivoting (packed L\U + permutation)
# ---------------------------------------------------------------------------


def lu(m: torch.Tensor):
    """Packed LU with partial pivoting.

    Returns ``(lu, perm)``: ``lu`` holds U on and above the diagonal and
    the unit lower-triangular L factors below; ``perm`` is int32
    ``[..., n]`` with ``P·A = L·U``, row ``i`` of the factored matrix
    having come from row ``perm[i]`` of ``A``. The pivot is the first row
    of largest magnitude."""
    n = m.shape[-1]
    a = m
    dev = m.device
    batch = a.shape[:-2]
    perm = torch.arange(n, dtype=torch.int32, device=dev).expand(
        batch + (n,))
    rows = torch.arange(n, device=dev)
    neg_inf = torch.tensor(-torch.inf, dtype=a.dtype, device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    one = torch.ones((), dtype=a.dtype, device=dev)
    for k in range(n):
        col = torch.where(rows >= k, torch.abs(a[..., :, k]), neg_inf)
        p = torch.argmax(col, dim=-1, keepdim=True)
        idx = rows.expand(batch + (n,))
        idx = torch.where(idx == k, p, torch.where(idx == p, k, idx))
        a = torch.gather(a, -2, idx[..., None].expand(a.shape))
        perm = torch.gather(perm, -1, idx)
        pivot = a[..., k, k]
        below = rows > k
        factors = torch.where(
            below, a[..., :, k] / torch.where(pivot == 0, one,
                                              pivot)[..., None], zero)
        # eliminate only columns > k: columns < k hold final L factors
        row_k = torch.where(rows > k, a[..., k, :], zero)
        a = a - factors[..., :, None] * row_k[..., None, :]
        a[..., :, k] = torch.where(below, factors, a[..., :, k])
    return a, perm


def lu_unpack(packed: torch.Tensor):
    n = packed.shape[-1]
    eye = torch.eye(n, dtype=packed.dtype, device=packed.device)
    return torch.tril(packed, -1) + eye, torch.triu(packed)


def lu_solve(packed: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given ``lu(A)``. ``b``: [..., n]."""
    n = packed.shape[-1]
    y = list(torch.gather(b, -1, perm.long()).unbind(-1))
    # forward substitution (unit lower)
    for i in range(1, n):
        y[i] = y[i] - torch.sum(packed[..., i, :i]
                                * torch.stack(y[:i], dim=-1), dim=-1)
    # back substitution
    x = y
    for i in reversed(range(n)):
        s = x[i]
        if i + 1 < n:
            s = s - torch.sum(packed[..., i, i + 1:]
                              * torch.stack(x[i + 1:], dim=-1), dim=-1)
        x[i] = s / packed[..., i, i]
    return torch.stack(x, dim=-1)


# ---------------------------------------------------------------------------
# QR (Householder)
# ---------------------------------------------------------------------------


def qr(m: torch.Tensor):
    """Householder QR: ``(q, r)`` with q orthogonal, r upper triangular."""
    n = m.shape[-1]
    r = m
    q = torch.eye(n, dtype=r.dtype, device=r.device).expand(r.shape)
    rows = torch.arange(n, device=r.device)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for k in range(n - 1):
        x = torch.where(rows >= k, r[..., :, k], zero)
        norm = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0)
        alpha = -sign * norm
        v = x.clone()
        v[..., k] = x[..., k] + (-alpha)
        vnorm2 = torch.sum(v * v, dim=-1)
        safe = vnorm2 > 1e-30
        inv = torch.where(safe, 2.0 / torch.where(safe, vnorm2, 1.0), 0.0)
        # r <- (I - 2vvᵀ/|v|²) r ;  q <- q (I - 2vvᵀ/|v|²)
        vr = torch.sum(v[..., :, None] * r, dim=-2)
        r = r - inv[..., None, None] * v[..., :, None] * vr[..., None, :]
        qv = torch.sum(q * v[..., None, :], dim=-1)
        q = q - inv[..., None, None] * qv[..., :, None] * v[..., None, :]
    return q, r


# ---------------------------------------------------------------------------
# Cholesky (unrolled Crout)
# ---------------------------------------------------------------------------


def cholesky(m: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L·Lᵀ = m (SPD input), unrolled; a pivot
    below 1e-30 is clamped to it."""
    n = m.shape[-1]
    zero = torch.zeros_like(m[..., 0, 0])
    l = [[zero] * n for _ in range(n)]
    for j in range(n):
        d = m[..., j, j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        ljj = torch.sqrt(torch.clamp(d, min=1e-30))
        l[j][j] = ljj
        for i in range(j + 1, n):
            s = m[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s / ljj
    return torch.stack([torch.stack(row, dim=-1) for row in l], dim=-2)


def cholesky_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = l.shape[-1]
    y = list(b.unbind(-1))
    for i in range(n):
        s = y[i]
        for k in range(i):
            s = s - l[..., i, k] * y[k]
        y[i] = s / l[..., i, i]
    x = y
    for i in reversed(range(n)):
        s = x[i]
        for k in range(i + 1, n):
            s = s - l[..., k, i] * x[k]
        x[i] = s / l[..., i, i]
    return torch.stack(x, dim=-1)


# ---------------------------------------------------------------------------
# Symmetric eigendecomposition (cyclic Jacobi, fixed sweeps)
# ---------------------------------------------------------------------------


def symmetric_eigen(m: torch.Tensor, *, sweeps: int = 8):
    """Eigenvalues and eigenvectors of a symmetric matrix: cyclic Jacobi
    with a fixed sweep count. Returns ``(w [..., n], v [..., n, n])``
    with ``m ≈ V diag(w) Vᵀ`` (eigenvectors in the columns), ascending;
    equal eigenvalues keep their diagonal order (a stable sort, as
    ``jnp.argsort``)."""
    n = m.shape[-1]
    a = m.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = a[..., p, p]
                aqq = a[..., q, q]
                apq = a[..., p, q]
                small = torch.abs(apq) < 1e-30
                tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
                t = torch.sign(tau) / (torch.abs(tau)
                                       + torch.sqrt(1.0 + tau * tau))
                t = torch.where(tau == 0.0, 1.0, t)
                t = torch.where(small, 0.0, t)
                c = torch.rsqrt(1.0 + t * t)
                s = t * c
                c1, s1 = c[..., None], s[..., None]
                # a <- Gᵀ a G on rows / columns p, q ; v <- v G
                ap, aq = a[..., p, :], a[..., q, :]
                new_p, new_q = c1 * ap - s1 * aq, s1 * ap + c1 * aq
                a[..., p, :], a[..., q, :] = new_p, new_q
                ap, aq = a[..., :, p], a[..., :, q]
                new_p, new_q = c1 * ap - s1 * aq, s1 * ap + c1 * aq
                a[..., :, p], a[..., :, q] = new_p, new_q
                vp, vq = v[..., :, p], v[..., :, q]
                new_p, new_q = c1 * vp - s1 * vq, s1 * vp + c1 * vq
                v[..., :, p], v[..., :, q] = new_p, new_q
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand(v.shape))
    return w, v


# ---------------------------------------------------------------------------
# SVD for 2×2 / 3×3 via eigen(AᵀA)
# ---------------------------------------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def svd(a: torch.Tensor):
    """SVD of 2×2 or 3×3 matrices: ``(u, s, vt)`` with
    ``a ≈ u @ diag(s) @ vt``, s descending, u and v orthogonal (det ±1)."""
    n = a.shape[-1]
    if n not in (2, 3):
        raise ValueError("svd supports n in {2, 3}")
    ata = torch.sum(a[..., :, :, None] * a[..., :, None, :], dim=-3)
    w, v = symmetric_eigen(ata)
    # descending singular values
    w = torch.flip(w, dims=(-1,))
    v = torch.flip(v, dims=(-1,))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    b = torch.sum(a[..., :, :, None] * v[..., None, :, :], dim=-2)  # U Σ
    eps = 1e-12
    u_cols = []
    for i in range(n):
        good = s[..., i] > eps
        u_cols.append(torch.where(
            good[..., None],
            b[..., :, i] / torch.where(good, s[..., i], 1.0)[..., None],
            0.0))
    # A·v/σ loses orthogonality as 1/σ for small singular values:
    # re-orthonormalise against the larger-σ columns (Gram-Schmidt of
    # column 1 against column 0, column 2 as their cross product, its sign
    # matched so the reconstruction keeps σ ≥ 0)
    if n == 3:
        bad1 = _dot(u_cols[1], u_cols[1]) < 0.5
        alt = _any_orthonormal(u_cols[0])
        c1 = torch.where(bad1, alt, u_cols[1])
        c1 = c1 - _dot(c1, u_cols[0]) * u_cols[0]
        c1n = torch.sqrt(_dot(c1, c1))
        u_cols[1] = torch.where(c1n > 1e-6,
                                c1 / torch.clamp(c1n, min=1e-30), alt)
        c2 = cross(u_cols[0], u_cols[1])
        flip = _dot(c2, u_cols[2]) < 0.0
        bad2 = _dot(u_cols[2], u_cols[2]) < 0.5
        u_cols[2] = torch.where(flip & ~bad2, -c2, c2)
    else:
        perp = torch.stack([-u_cols[0][..., 1], u_cols[0][..., 0]], dim=-1)
        flip = _dot(perp, u_cols[1]) < 0.0
        bad1 = _dot(u_cols[1], u_cols[1]) < 0.5
        u_cols[1] = torch.where(flip & ~bad1, -perp, perp)
    # the zero matrix: the identity
    zero = s[..., 0] < eps
    u = torch.stack(u_cols, dim=-1)
    u = torch.where(zero[..., None, None],
                    torch.eye(n, dtype=a.dtype, device=a.device), u)
    return u, s, torch.transpose(v, -1, -2)


def _any_orthonormal(x: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to the unit 3-vector x (branch-free)."""
    ex = torch.zeros_like(x)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(x)
    ey[..., 1] = 1.0
    ref = torch.where((torch.abs(x[..., 0]) > 0.9)[..., None], ey, ex)
    c = cross(x, ref)
    return c * torch.rsqrt(_dot(c, c) + 1e-30)


def _ex(n: int, device) -> tuple:
    return (torch.eye(n, dtype=torch.float32, device=device)[None].repeat(
        32, 1, 1) * 2.0,)


register_module(
    KernelModule(
        "geometry.decomp",
        provides={
            "lu": lu, "lu_unpack": lu_unpack, "lu_solve": lu_solve,
            "qr": qr, "cholesky": cholesky, "cholesky_solve": cholesky_solve,
            "symmetric_eigen": symmetric_eigen, "svd": svd,
        },
        entries={
            **{f"{name}{n}": EntryPoint(
                fn=fn, example_args=functools.partial(_ex, n))
               for name, fn in (("lu", lu), ("qr", qr),
                                ("cholesky", cholesky),
                                ("eig", symmetric_eigen))
               for n in (2, 3, 4)},
            **{f"svd{n}": EntryPoint(fn=svd,
                                     example_args=functools.partial(_ex, n))
               for n in (2, 3)},
        },
        doc="Batched LU/QR/Cholesky/Eigen/SVD for sizes 2-4 (the "
            "reference's geometry decompositions).",
    )
)
