"""Batched closed-form inverses and determinants of 2×2, 3×3 and 4×4
matrices (counterpart of ``wgmath_tpu/geometry/inv.py``, the reference's
``inv2`` / ``inv3`` / ``inv4``), over any leading batch axes. The cofactor
expressions and their order of terms are the JAX package's. Plain tensor
code: the JAX package has no kernel here either."""

from __future__ import annotations

import torch

from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)


def det2(m: torch.Tensor) -> torch.Tensor:
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2(m: torch.Tensor) -> torch.Tensor:
    d = det2(m)[..., None, None]
    adj = torch.stack([
        torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
        torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / d


def det3(m: torch.Tensor) -> torch.Tensor:
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                        - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                          - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                          - m[..., 1, 1] * m[..., 2, 0])
    )


def inv3(m: torch.Tensor) -> torch.Tensor:
    # adjugate: cofactor(j, i) / det
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r = [k for k in range(3) if k != i]
            s = [k for k in range(3) if k != j]
            minor = (m[..., r[0], s[0]] * m[..., r[1], s[1]]
                     - m[..., r[0], s[1]] * m[..., r[1], s[0]])
            c[j][i] = ((-1.0) ** (i + j)) * minor
    adj = torch.stack([torch.stack(row, dim=-1) for row in c], dim=-2)
    return adj / det3(m)[..., None, None]


def _minors4(m: torch.Tensor) -> tuple:
    """The twelve 2×2 minors of rows (0, 1) and (2, 3), as ``det4`` and
    ``inv4`` share them: ``(s0..s5, c0..c5)``."""
    def minor(r0, r1, c0, c1):
        return m[..., r0, c0] * m[..., r1, c1] - m[..., r0, c1] * m[..., r1, c0]

    s = (minor(0, 1, 0, 1), minor(0, 1, 0, 2), minor(0, 1, 0, 3),
         minor(0, 1, 1, 2), minor(0, 1, 1, 3), minor(0, 1, 2, 3))
    c = (minor(2, 3, 0, 1), minor(2, 3, 0, 2), minor(2, 3, 0, 3),
         minor(2, 3, 1, 2), minor(2, 3, 1, 3), minor(2, 3, 2, 3))
    return s, c


def det4(m: torch.Tensor) -> torch.Tensor:
    (s0, s1, s2, s3, s4, s5), (c0, c1, c2, c3, c4, c5) = _minors4(m)
    return s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0


def inv4(m: torch.Tensor) -> torch.Tensor:
    """Cramer's rule with the cached 2×2 minors."""
    (s0, s1, s2, s3, s4, s5), (c0, c1, c2, c3, c4, c5) = _minors4(m)
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det
    a = m
    out = torch.stack([
        torch.stack([a[..., 1, 1] * c5 - a[..., 1, 2] * c4 + a[..., 1, 3] * c3,
                     -a[..., 0, 1] * c5 + a[..., 0, 2] * c4 - a[..., 0, 3] * c3,
                     a[..., 3, 1] * s5 - a[..., 3, 2] * s4 + a[..., 3, 3] * s3,
                     -a[..., 2, 1] * s5 + a[..., 2, 2] * s4 - a[..., 2, 3] * s3],
                    dim=-1),
        torch.stack([-a[..., 1, 0] * c5 + a[..., 1, 2] * c2 - a[..., 1, 3] * c1,
                     a[..., 0, 0] * c5 - a[..., 0, 2] * c2 + a[..., 0, 3] * c1,
                     -a[..., 3, 0] * s5 + a[..., 3, 2] * s2 - a[..., 3, 3] * s1,
                     a[..., 2, 0] * s5 - a[..., 2, 2] * s2 + a[..., 2, 3] * s1],
                    dim=-1),
        torch.stack([a[..., 1, 0] * c4 - a[..., 1, 1] * c2 + a[..., 1, 3] * c0,
                     -a[..., 0, 0] * c4 + a[..., 0, 1] * c2 - a[..., 0, 3] * c0,
                     a[..., 3, 0] * s4 - a[..., 3, 1] * s2 + a[..., 3, 3] * s0,
                     -a[..., 2, 0] * s4 + a[..., 2, 1] * s2 - a[..., 2, 3] * s0],
                    dim=-1),
        torch.stack([-a[..., 1, 0] * c3 + a[..., 1, 1] * c1 - a[..., 1, 2] * c0,
                     a[..., 0, 0] * c3 - a[..., 0, 1] * c1 + a[..., 0, 2] * c0,
                     -a[..., 3, 0] * s3 + a[..., 3, 1] * s1 - a[..., 3, 2] * s0,
                     a[..., 2, 0] * s3 - a[..., 2, 1] * s1 + a[..., 2, 2] * s0],
                    dim=-1),
    ], dim=-2)
    return out * inv_det[..., None, None]


_INV = {2: inv2, 3: inv3, 4: inv4}


def inv(m: torch.Tensor) -> torch.Tensor:
    """Dispatch by the trailing dimension (2, 3 or 4)."""
    n = m.shape[-1]
    if m.shape[-2] != n:
        raise ValueError("inv expects square matrices")
    return _INV[n](m)


register_module(
    KernelModule(
        "geometry.inv",
        provides={"inv2": inv2, "inv3": inv3, "inv4": inv4, "inv": inv,
                  "det2": det2, "det3": det3},
        entries={
            f"inv{n}": EntryPoint(
                fn=_INV[n],
                example_args=(lambda device, n=n: (
                    torch.eye(n, device=device)[None].repeat(64, 1, 1),)),
            )
            for n in (2, 3, 4)
        },
        doc="Closed-form batched small-matrix inverses (the reference's "
            "geometry/inv.wgsl).",
    )
)
