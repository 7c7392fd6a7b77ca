"""Simulation parameters and the soft-constraint (CFM/ERP) math
(counterpart of ``wgmath_tpu/dynamics/sim_params.py``). ``dt`` inside the
solver is the substep dt: ``substep()`` divides by the iteration count."""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.core.dispatch import resolve_device

MAX_FLT = 3.4e38
TWO_PI = 6.283185307179586


@dataclasses.dataclass(frozen=True)
class SimParams:
    dt: float = 1.0 / 60.0
    contact_damping_ratio: float = 5.0
    contact_natural_frequency: float = 30.0
    joint_natural_frequency: float = 1.0e6
    joint_damping_ratio: float = 1.0
    warmstart_coefficient: float = 1.0
    length_unit: float = 1.0
    normalized_allowed_linear_error: float = 0.001
    normalized_max_corrective_velocity: float = 10.0
    normalized_prediction_distance: float = 0.002
    num_solver_iterations: int = 4
    gravity: tuple = (0.0, -9.81, 0.0)
    friction: float = 0.5
    restitution: float = 0.0

    @staticmethod
    def tgs_soft(**kw) -> "SimParams":
        """The soft TGS solver's parameters (the defaults)."""
        return SimParams(**kw)

    @staticmethod
    def jacobi(**kw) -> "SimParams":
        """The Jacobi solver's parameters: no warmstart by default."""
        kw.setdefault("warmstart_coefficient", 0.0)
        return SimParams(**kw)

    def substep(self) -> "SimParams":
        return dataclasses.replace(self,
                                   dt=self.dt / self.num_solver_iterations)

    def with_dim(self, dim: int) -> "SimParams":
        g = self.gravity
        if dim == 2 and len(g) == 3:
            return dataclasses.replace(self, gravity=(g[0], g[1]))
        return self

    @property
    def inv_dt(self) -> float:
        return 0.0 if self.dt == 0.0 else 1.0 / self.dt

    @property
    def contact_erp_inv_dt(self) -> float:
        w = self.contact_natural_frequency * TWO_PI
        return w / (self.dt * w + 2.0 * self.contact_damping_ratio)

    @property
    def contact_erp(self) -> float:
        return self.dt * self.contact_erp_inv_dt

    @property
    def joint_erp_inv_dt(self) -> float:
        w = self.joint_natural_frequency * TWO_PI
        return w / (self.dt * w + 2.0 * self.joint_damping_ratio)

    @property
    def joint_erp(self) -> float:
        return self.dt * self.joint_erp_inv_dt

    @property
    def joint_cfm_coeff(self) -> float:
        erp = self.joint_erp
        if erp == 0.0:
            return 0.0
        inv_erp_m1 = 1.0 / erp - 1.0
        return inv_erp_m1 * inv_erp_m1 / (
            (1.0 + inv_erp_m1) * 4.0
            * self.joint_damping_ratio * self.joint_damping_ratio)

    @property
    def contact_cfm_factor(self) -> float:
        erp = self.contact_erp
        if erp == 0.0:
            return 0.0
        inv_erp_m1 = 1.0 / erp - 1.0
        cfm_coeff = inv_erp_m1 * inv_erp_m1 / (
            (1.0 + inv_erp_m1) * 4.0
            * self.contact_damping_ratio * self.contact_damping_ratio)
        return 1.0 / (1.0 + cfm_coeff)

    @property
    def allowed_linear_error(self) -> float:
        return self.normalized_allowed_linear_error * self.length_unit

    @property
    def max_corrective_velocity(self) -> float:
        if self.normalized_max_corrective_velocity != MAX_FLT:
            return self.normalized_max_corrective_velocity * self.length_unit
        return MAX_FLT

    @property
    def prediction_distance(self) -> float:
        return self.normalized_prediction_distance * self.length_unit

    def gravity_array(self, dim: int, device=None) -> torch.Tensor:
        """The gravity vector's first ``dim`` components; ``device`` None
        means the card."""
        return torch.tensor(self.gravity[:dim], dtype=torch.float32,
                            device=resolve_device(device))
