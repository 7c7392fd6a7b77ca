"""Rigid-body state and integration, structure of arrays (counterpart of
``wgmath_tpu/dynamics/body.py``). The dimension is read from the shapes:
2D bodies have a scalar angular velocity and inverse inertia.

- ``inv_mass`` is a per-axis vector (axis locking).
- 3D local inertia is (principal frame quaternion, inverse principal
  inertia); world inverse inertia is R diag R^T. 2D has no inertia frame
  (``None``) and a scalar inverse inertia, the same in the world.
- Velocity integration is semi-implicit Euler about the COM with a
  quaternion exponential map (3D) or a rotation by the angle (2D).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)
from wgmath_tpu_torch.geometry import quat, rot2
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.sim import Sim


@dataclasses.dataclass
class Velocity:
    linear: torch.Tensor  # [N, dim]
    angular: torch.Tensor  # [N, 3] (3D) or [N] (2D)

    @staticmethod
    def zero(n: int, dim: int = 3, *, device=None) -> "Velocity":
        """Zero velocities; ``device`` None means the card."""
        device = resolve_device(device)
        return Velocity(torch.zeros((n, dim), device=device),
                        torch.zeros((n, 3) if dim == 3 else (n,),
                                    device=device))


@dataclasses.dataclass
class LocalMassProperties:
    inv_mass: torch.Tensor  # [N, dim] per axis
    com: torch.Tensor  # [N, dim]
    inertia_ref_frame: torch.Tensor | None  # [N, 4] (3D) or None (2D)
    inv_principal_inertia: torch.Tensor  # [N, 3] (3D) or [N] (2D)


@dataclasses.dataclass
class WorldMassProperties:
    inv_mass: torch.Tensor  # [N, dim]
    com: torch.Tensor  # [N, dim]
    inv_inertia: torch.Tensor  # [N, 3, 3] (3D) or [N] (2D)


@dataclasses.dataclass
class Bodies:
    """All rigid bodies. ``kinematic`` marks one-way-coupled bodies: zero
    inverse mass, but their prescribed velocity is kept through the solve
    and integrates their pose."""

    poses: Sim
    vels: Velocity
    local_mprops: LocalMassProperties
    kinematic: torch.Tensor | None = None  # [N] bool

    @property
    def num_bodies(self) -> int:
        return self.poses.translation.shape[0]

    @property
    def dim(self) -> int:
        return self.poses.translation.shape[-1]

    def is_dynamic(self) -> torch.Tensor:
        """[N] bool — any unlocked translation axis."""
        return torch.any(self.local_mprops.inv_mass != 0.0, dim=-1)

    def is_kinematic(self) -> torch.Tensor:
        if self.kinematic is None:
            return torch.zeros(self.num_bodies, dtype=torch.bool,
                               device=self.poses.translation.device)
        return self.kinematic

    def is_moving(self) -> torch.Tensor:
        """[N] bool — bodies whose pose integrates (dynamic ∪ kinematic)."""
        return self.is_dynamic() | self.is_kinematic()


def update_mprops(poses: Sim,
                  local: LocalMassProperties) -> WorldMassProperties:
    """World-space mass properties from the pose."""
    world_com = sim_ops.mul_pt(poses, local.com)
    if poses.translation.shape[-1] == 2:
        return WorldMassProperties(local.inv_mass, world_com,
                                   local.inv_principal_inertia)
    r = quat.to_matrix(quat.mul(poses.rotation, local.inertia_ref_frame))
    inv_inertia = torch.einsum("nik,nk,njk->nij", r,
                               local.inv_principal_inertia, r)
    return WorldMassProperties(local.inv_mass, world_com, inv_inertia)


def apply_impulse(mprops: WorldMassProperties, vel: Velocity,
                  lin_imp: torch.Tensor, ang_imp: torch.Tensor) -> Velocity:
    """Velocities after an impulse: the inverse mass times the linear part,
    the world inverse inertia times the angular part."""
    dlin = mprops.inv_mass * lin_imp
    if mprops.inv_inertia.dim() == vel.angular.dim() + 1:  # 3D matrix
        dang = torch.einsum("...ij,...j->...i", mprops.inv_inertia, ang_imp)
    else:
        dang = mprops.inv_inertia * ang_imp
    return Velocity(vel.linear + dlin, vel.angular + dang)


def integrate_forces(mprops: WorldMassProperties, vel: Velocity,
                     lin_force: torch.Tensor, ang_force: torch.Tensor,
                     dt) -> Velocity:
    """Explicit Euler on the velocities."""
    v = apply_impulse(mprops, vel, lin_force, ang_force)
    return Velocity(vel.linear + (v.linear - vel.linear) * dt,
                    vel.angular + (v.angular - vel.angular) * dt)


def integrate_velocity(poses: Sim, vels: Velocity, local_com: torch.Tensor,
                       dt: float) -> Sim:
    """Semi-implicit Euler pose update about the COM."""
    init_com = sim_ops.mul_pt(poses, local_com)
    init_tra = poses.translation
    if init_tra.shape[-1] == 2:
        delta_ang = rot2.from_angle(vels.angular * dt)
        rotated = rot2.mul_vec(delta_ang, init_tra - init_com)
        new_rot = rot2.normalize(rot2.mul(delta_ang, poses.rotation))
    else:
        delta_ang = quat.from_scaled_axis(vels.angular * dt)
        rotated = quat.mul_vec(delta_ang, init_tra - init_com)
        new_rot = quat.normalize(quat.mul(delta_ang, poses.rotation))
    new_tra = init_com + rotated * poses.scale[..., None] + vels.linear * dt
    return Sim(new_rot, new_tra, poses.scale)


def velocity_at_point(com: torch.Tensor, vels: Velocity,
                      point: torch.Tensor) -> torch.Tensor:
    """v + ω × (p - com) (2D: ω times the arm turned a quarter)."""
    arm = point - com
    if point.shape[-1] == 2:
        perp = torch.stack([-arm[..., 1], arm[..., 0]], dim=-1)
        return vels.linear + vels.angular[..., None] * perp
    return vels.linear + quat.cross(vels.angular, arm)


def _dyn(n: int, dev, dynamic) -> torch.Tensor:
    return (torch.ones(n, dtype=torch.bool, device=dev) if dynamic is None
            else torch.as_tensor(dynamic, device=dev))


def _planar(inv_m, inv_i) -> LocalMassProperties:
    """2D mass properties: per-axis inverse mass, no inertia frame, the
    scalar inverse inertia."""
    n = inv_m.shape[0]
    return LocalMassProperties(inv_m[:, None].repeat(1, 2),
                               torch.zeros((n, 2), device=inv_m.device),
                               None, inv_i)


def ball_local_mprops(radius: torch.Tensor, density: float = 1.0, *,
                      dim: int = 3, dynamic=None) -> LocalMassProperties:
    """Uniform ball (3D) or disk (2D) mass properties."""
    radius = radius.to(torch.float32)
    n = radius.shape[0]
    dev = radius.device
    if dim == 3:
        mass = density * (4.0 / 3.0) * math.pi * radius ** 3
        inertia = 0.4 * mass * radius ** 2
    else:
        mass = density * math.pi * radius ** 2
        inertia = 0.5 * mass * radius ** 2
    dyn = _dyn(n, dev, dynamic)
    inv_m = torch.where(dyn, 1.0 / mass, torch.zeros_like(mass))
    inv_i = torch.where(dyn, 1.0 / inertia, torch.zeros_like(inertia))
    if dim == 2:
        return _planar(inv_m, inv_i)
    return LocalMassProperties(inv_m[:, None].repeat(1, 3),
                               torch.zeros((n, 3), device=dev),
                               quat.identity((n,), device=dev),
                               inv_i[:, None].repeat(1, 3))


def cuboid_local_mprops(half_extents: torch.Tensor, density: float = 1.0,
                        *, dynamic=None) -> LocalMassProperties:
    """Uniform box mass properties, [N, dim] half extents."""
    he = half_extents.to(torch.float32)
    n = he.shape[0]
    dev = he.device
    sides = 2.0 * he
    if he.shape[1] == 2:
        mass = density * sides[:, 0] * sides[:, 1]
        inertia = mass / 12.0 * (sides[:, 0] ** 2 + sides[:, 1] ** 2)
        dyn = _dyn(n, dev, dynamic)
        return _planar(torch.where(dyn, 1.0 / mass, torch.zeros_like(mass)),
                       torch.where(dyn, 1.0 / inertia,
                                   torch.zeros_like(inertia)))
    mass = density * sides[:, 0] * sides[:, 1] * sides[:, 2]
    ix = mass / 12.0 * (sides[:, 1] ** 2 + sides[:, 2] ** 2)
    iy = mass / 12.0 * (sides[:, 0] ** 2 + sides[:, 2] ** 2)
    iz = mass / 12.0 * (sides[:, 0] ** 2 + sides[:, 1] ** 2)
    inertia = torch.stack([ix, iy, iz], dim=-1)
    dyn = (torch.ones(n, dtype=torch.bool, device=dev) if dynamic is None
           else torch.as_tensor(dynamic, device=dev))
    inv_m = torch.where(dyn, 1.0 / mass, torch.zeros_like(mass))
    inv_i = torch.where(dyn[:, None], 1.0 / inertia,
                        torch.zeros_like(inertia))
    return LocalMassProperties(inv_m[:, None].repeat(1, 3),
                               torch.zeros((n, 3), device=dev),
                               quat.identity((n,), device=dev), inv_i)


def _axial_mprops(mass, inertia, com, dynamic) -> LocalMassProperties:
    """Mass properties of shapes symmetric about local Y from their masses
    [N], principal moments [N, 3] and centres of mass [N, 3]."""
    n, dev = inertia.shape[0], inertia.device
    dyn = (torch.ones(n, dtype=torch.bool, device=dev) if dynamic is None
           else torch.as_tensor(dynamic, device=dev))
    inv_m = torch.where(dyn, 1.0 / mass, torch.zeros_like(mass))
    inv_i = torch.where(dyn[:, None], 1.0 / inertia,
                        torch.zeros_like(inertia))
    return LocalMassProperties(inv_m[:, None].repeat(1, 3), com,
                               quat.identity((n,), device=dev), inv_i)


def capsule_local_mprops(half_heights: torch.Tensor, radii: torch.Tensor,
                         density: float = 1.0, *, dim: int = 3,
                         dynamic=None) -> LocalMassProperties:
    """Solid capsule along local Y: a cylinder and two hemispheres (3D), a
    rectangle and two half disks (2D)."""
    hh = half_heights.to(torch.float32)
    r = radii.to(torch.float32)
    if dim == 2:
        m_rect = density * 2.0 * r * 2.0 * hh
        m_half = density * math.pi * r ** 2 / 2.0
        mass = m_rect + 2.0 * m_half
        c = 4.0 * r / (3.0 * math.pi)
        i_half_com = m_half * r ** 2 / 2.0 - m_half * c ** 2
        inertia = (m_rect * (4.0 * r ** 2 + 4.0 * hh ** 2) / 12.0
                   + 2.0 * (i_half_com + m_half * (hh + c) ** 2))
        dyn = _dyn(hh.shape[0], hh.device, dynamic)
        return _planar(torch.where(dyn, 1.0 / mass, torch.zeros_like(mass)),
                       torch.where(dyn, 1.0 / inertia,
                                   torch.zeros_like(inertia)))
    m_cyl = density * math.pi * r ** 2 * 2.0 * hh
    m_hemi = density * (2.0 / 3.0) * math.pi * r ** 3
    mass = m_cyl + 2.0 * m_hemi
    iy = m_cyl * r ** 2 / 2.0 + 2.0 * m_hemi * (2.0 / 5.0) * r ** 2
    c = 3.0 * r / 8.0  # a hemisphere's COM above its flat face
    i_hemi_com = (83.0 / 320.0) * m_hemi * r ** 2
    ix = (m_cyl * (3.0 * r ** 2 + 4.0 * hh ** 2) / 12.0
          + 2.0 * (i_hemi_com + m_hemi * (hh + c) ** 2))
    return _axial_mprops(mass, torch.stack([ix, iy, ix], dim=-1),
                         torch.zeros((hh.shape[0], 3), device=hh.device),
                         dynamic)


def cylinder_local_mprops(half_heights: torch.Tensor, radii: torch.Tensor,
                          density: float = 1.0, *,
                          dynamic=None) -> LocalMassProperties:
    """Solid 3D cylinder, axis +Y."""
    hh = half_heights.to(torch.float32)
    r = radii.to(torch.float32)
    mass = density * math.pi * r ** 2 * 2.0 * hh
    iy = mass * r ** 2 / 2.0
    ix = mass * (3.0 * r ** 2 + 4.0 * hh ** 2) / 12.0
    return _axial_mprops(mass, torch.stack([ix, iy, ix], dim=-1),
                         torch.zeros((hh.shape[0], 3), device=hh.device),
                         dynamic)


def cone_local_mprops(half_heights: torch.Tensor, radii: torch.Tensor,
                      density: float = 1.0, *,
                      dynamic=None) -> LocalMassProperties:
    """Solid 3D cone, apex at +half_height; its COM sits a quarter of the
    height above the base."""
    hh = half_heights.to(torch.float32)
    r = radii.to(torch.float32)
    big_h = 2.0 * hh
    mass = density * math.pi * r ** 2 * big_h / 3.0
    iy = 0.3 * mass * r ** 2
    ix = mass * (3.0 * r ** 2 / 20.0 + 3.0 * big_h ** 2 / 80.0)
    com = torch.zeros((hh.shape[0], 3), device=hh.device)
    com[:, 1] = -hh / 2.0
    return _axial_mprops(mass, torch.stack([ix, iy, ix], dim=-1), com,
                         dynamic)


def _example_bodies(device) -> tuple:
    n = 64
    return (Bodies(sim_ops.identity((n,), dim=3, device=device),
                   Velocity.zero(n, 3, device=device),
                   ball_local_mprops(torch.ones(n, device=device), dim=3)),)


register_module(
    KernelModule(
        "dynamics.body",
        deps=("geometry.sim",),
        provides={
            "update_mprops": update_mprops,
            "apply_impulse": apply_impulse,
            "integrate_forces": integrate_forces,
            "integrate_velocity": integrate_velocity,
            "velocity_at_point": velocity_at_point,
        },
        entries={
            "update_mprops": EntryPoint(
                fn=lambda b: update_mprops(b.poses, b.local_mprops),
                example_args=_example_bodies),
            "integrate": EntryPoint(
                fn=lambda b: integrate_velocity(b.poses, b.vels,
                                                b.local_mprops.com,
                                                1.0 / 60.0),
                example_args=_example_bodies),
        },
        doc="Rigid-body state + integration (the reference's "
            "dynamics/body).",
    )
)
