"""Batched 3D similarity transforms ``p ↦ s·R·p + t`` (counterpart of
``wgmath_tpu/geometry/sim.py``, row-major storage only)."""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.geometry import quat


@dataclasses.dataclass
class Sim:
    rotation: torch.Tensor  # [..., 4] quat xyzw
    translation: torch.Tensor  # [..., 3]
    scale: torch.Tensor  # [...]

    def take(self, idx) -> "Sim":
        return Sim(self.rotation[idx], self.translation[idx], self.scale[idx])


def mul_pt(a: Sim, p: torch.Tensor) -> torch.Tensor:
    return a.scale[..., None] * quat.mul_vec(a.rotation, p) + a.translation


def inv_mul_pt(a: Sim, p: torch.Tensor) -> torch.Tensor:
    return (quat.inv_mul_vec(a.rotation, p - a.translation)
            / a.scale[..., None])


def mul_unit_vec(a: Sim, v: torch.Tensor) -> torch.Tensor:
    return quat.mul_vec(a.rotation, v)


def inv_mul_unit_vec(a: Sim, v: torch.Tensor) -> torch.Tensor:
    return quat.inv_mul_vec(a.rotation, v)
