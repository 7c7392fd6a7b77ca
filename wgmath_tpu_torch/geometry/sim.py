"""Batched 2D/3D similarity transforms ``p ↦ s·R·p + t`` (counterpart of
``wgmath_tpu/geometry/sim.py``).

``rotation`` is a ``[..., 4]`` quaternion (3D) or a ``[..., 2]`` cos/sin
pair (2D), ``translation`` ``[..., dim]``, ``scale`` ``[...]``; the
dimension is read from the translation. ``cm=True`` marks component-major
storage of a flat batch: ``rotation`` a tuple of four ``[N]`` rows (xyzw),
``translation`` a tuple of ``dim`` rows, ``scale`` ``[N]``. The compositions
take either storage (both operands alike); cm composition is 3D only.

The JAX package also sends large row-major 3D batches through a transposed
``[4, N]`` route that only fills the TPU's lanes; the port computes the
same terms without it.
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)
from wgmath_tpu_torch.geometry import quat, rot2


@dataclasses.dataclass
class Sim:
    rotation: torch.Tensor | tuple  # [..., 4] quat xyzw / [..., 2] cos-sin
    translation: torch.Tensor | tuple  # [..., dim]
    scale: torch.Tensor  # [...]
    cm: bool = False  # component-major: tuples of [N] rows

    @property
    def dim(self) -> int:
        return (len(self.translation) if self.cm
                else self.translation.shape[-1])

    def _rot(self):
        return quat if self.dim == 3 else rot2

    def take(self, idx) -> "Sim":
        return Sim(self.rotation[idx], self.translation[idx], self.scale[idx])


def to_cm(a: Sim) -> Sim:
    """Row-major flat batch → component-major storage."""
    if a.cm:
        return a
    if a.rotation.ndim != 2:
        raise ValueError("component-major needs a flat batch")
    return Sim(quat.split_soa(a.rotation), quat.split_soa(a.translation),
               a.scale, cm=True)


def from_cm(a: Sim) -> Sim:
    if not a.cm:
        return a
    return Sim(quat.merge_soa(a.rotation), quat.merge_soa(a.translation),
               a.scale)


def identity(batch_shape=(), dim: int = 3, *, device=None) -> Sim:
    """Identity similarities; ``device`` None means the card."""
    device = resolve_device(device)
    rot = (quat.identity(batch_shape, device=device) if dim == 3
           else rot2.identity(batch_shape, device=device))
    shape = tuple(batch_shape)
    return Sim(rot, torch.zeros(shape + (dim,), device=device),
               torch.ones(shape, device=device))


def from_parts(rotation, translation, scale=None) -> Sim:
    translation = torch.as_tensor(translation)
    if scale is None:
        scale = torch.ones(translation.shape[:-1], dtype=torch.float32,
                           device=translation.device)
    return Sim(torch.as_tensor(rotation), translation, torch.as_tensor(scale))


def _need_cm3(a: Sim, b: Sim) -> None:
    if not (a.cm and b.cm and a.dim == 3):
        raise ValueError("component-major composition is 3D and needs both "
                         "operands cm")


def normalize_rotation(a: Sim) -> Sim:
    """Renormalize the rotation (drift control in long compose chains)."""
    if a.cm:
        return Sim(quat.normalize_soa(a.rotation), a.translation, a.scale,
                   cm=True)
    return Sim(a._rot().normalize(a.rotation), a.translation, a.scale)


def mul(a: Sim, b: Sim) -> Sim:
    """Composition a ∘ b: (sa·sb, Ra·Rb, sa·Ra·tb + ta)."""
    if a.cm or b.cm:
        _need_cm3(a, b)
        rot = quat._mul_soa(a.rotation, b.rotation)
        rt = quat._mul_vec_soa(a.rotation, b.translation)
        tr = tuple(a.scale * r + t for r, t in zip(rt, a.translation))
        return Sim(rot, tr, a.scale * b.scale, cm=True)
    r = a._rot()
    return Sim(
        r.mul(a.rotation, b.rotation),
        a.scale[..., None] * r.mul_vec(a.rotation, b.translation)
        + a.translation,
        a.scale * b.scale,
    )


def inv(a: Sim) -> Sim:
    inv_s = 1.0 / a.scale
    if a.cm:
        if a.dim != 3:
            raise ValueError("component-major inverse is 3D-only")
        inv_rot = quat._conj_soa(a.rotation)
        rt = quat._mul_vec_soa(inv_rot, a.translation)
        return Sim(inv_rot, tuple(-inv_s * r for r in rt), inv_s, cm=True)
    r = a._rot()
    inv_rot = r.inv(a.rotation)
    return Sim(inv_rot,
               -inv_s[..., None] * r.mul_vec(inv_rot, a.translation), inv_s)


def inv_mul(a: Sim, b: Sim) -> Sim:
    """a⁻¹ ∘ b without forming the full inverse."""
    inv_s = 1.0 / a.scale
    if a.cm or b.cm:
        _need_cm3(a, b)
        inv_rot = quat._conj_soa(a.rotation)
        rot = quat._mul_soa(inv_rot, b.rotation)
        rt = quat._mul_vec_soa(
            inv_rot, tuple(bb - aa for bb, aa
                           in zip(b.translation, a.translation)))
        return Sim(rot, tuple(inv_s * r for r in rt), inv_s * b.scale,
                   cm=True)
    r = a._rot()
    inv_rot = r.inv(a.rotation)
    return Sim(
        r.mul(inv_rot, b.rotation),
        inv_s[..., None] * r.mul_vec(inv_rot, b.translation - a.translation),
        inv_s * b.scale,
    )


def mul_pt(a: Sim, p):
    """``s·R·p + t``; with cm storage ``p`` is a tuple of ``[N]`` rows."""
    if a.cm:
        rt = quat._mul_vec_soa(a.rotation, p)
        return tuple(a.scale * r + t for r, t in zip(rt, a.translation))
    return (a.scale[..., None] * a._rot().mul_vec(a.rotation, p)
            + a.translation)


def inv_mul_pt(a: Sim, p: torch.Tensor) -> torch.Tensor:
    return (a._rot().inv_mul_vec(a.rotation, p - a.translation)
            / a.scale[..., None])


def mul_vec(a: Sim, v):
    """``s·R·v``; with cm storage ``v`` is a tuple of ``[N]`` rows."""
    if a.cm:
        return tuple(a.scale * r for r in quat._mul_vec_soa(a.rotation, v))
    return a.scale[..., None] * a._rot().mul_vec(a.rotation, v)


def inv_mul_vec(a: Sim, v):
    """``R⁻¹·v / s``; with cm storage ``v`` is a tuple of ``[N]`` rows."""
    if a.cm:
        return tuple(r / a.scale for r in
                     quat._mul_vec_soa(quat._conj_soa(a.rotation), v))
    return a._rot().inv_mul_vec(a.rotation, v) / a.scale[..., None]


def mul_unit_vec(a: Sim, v: torch.Tensor) -> torch.Tensor:
    return a._rot().mul_vec(a.rotation, v)


def inv_mul_unit_vec(a: Sim, v: torch.Tensor) -> torch.Tensor:
    return a._rot().inv_mul_vec(a.rotation, v)


def _example(dim):
    def make(device):
        n = 256
        rot = torch.tensor([0.0, 0.0, 0.0, 1.0] if dim == 3 else [1.0, 0.0],
                           device=device).repeat(n, 1)
        return tuple(Sim(rot, torch.ones((n, dim), device=device),
                         torch.ones((n,), device=device)) for _ in range(2))
    return make


register_module(
    KernelModule(
        "geometry.sim",
        deps=("geometry.quat", "geometry.rot2"),
        provides={
            "sim_identity": identity,
            "sim_to_cm": to_cm,
            "sim_from_cm": from_cm,
            "sim_normalize_rotation": normalize_rotation,
            "sim_mul": mul,
            "sim_inv": inv,
            "sim_inv_mul": inv_mul,
            "sim_mul_pt": mul_pt,
            "sim_inv_mul_pt": inv_mul_pt,
            "sim_mul_vec": mul_vec,
            "sim_inv_mul_vec": inv_mul_vec,
            "sim_mul_unit_vec": mul_unit_vec,
            "sim_inv_mul_unit_vec": inv_mul_unit_vec,
        },
        entries={
            "sim3_compose": EntryPoint(
                fn=lambda a, b: mul(a, inv(b)),
                example_args=_example(3),
            ),
            "sim2_compose": EntryPoint(
                fn=lambda a, b: mul(a, inv(b)),
                example_args=_example(2),
            ),
        },
        doc="Composable similarity transforms.",
    )
)
