"""Rigid-body dynamics (counterpart of ``wgmath_tpu/dynamics``, with the
same names): bodies and mass properties, the simulation parameters,
contact constraints and the solver."""

from wgmath_tpu_torch.dynamics.body import (  # noqa: F401
    Bodies,
    LocalMassProperties,
    Velocity,
    WorldMassProperties,
    apply_impulse,
    ball_local_mprops,
    cuboid_local_mprops,
    integrate_forces,
    integrate_velocity,
    update_mprops,
    velocity_at_point,
)
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: F401
from wgmath_tpu_torch.dynamics.constraint import (  # noqa: F401
    ContactConstraints,
    Contacts,
    build_constraints,
    remove_cfm_and_bias,
    update_constraints,
)
from wgmath_tpu_torch.dynamics.solver import (  # noqa: F401
    build_body_constraint_csr,
    color_constraints,
    gs_colored_pass,
    jacobi_pass,
    solve,
    transfer_warmstart,
    warmstart_apply,
)
