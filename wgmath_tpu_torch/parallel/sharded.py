"""Round-1 scale-out: the physics step with the bodies sharded across the
ranks of a ``torch.distributed`` group (counterpart of
``wgmath_tpu/parallel/sharded.py``; ``sharded_pipeline`` is the full
pipeline).

- Rank k holds the body rows ``[k·m, (k+1)·m)`` (:func:`shard_state` pads
  the body count to a multiple of the rank count with static slots).
- Each step all-gathers the bodies, tests the rank's row block against
  every body in the brute-force broad phase (``find_pairs_partial``), runs
  the narrow phase on the rank's pairs, all-gathers the contacts and
  solves them on every rank, each colour split across the ranks
  (``solver.solve(shard=...)``; Jacobi replicated). Each rank keeps its
  own rows of the result.

:func:`body_mesh` describes a group that is already initialised; the
package starts no processes.
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.broad_phase.brute_force import find_pairs_partial
from wgmath_tpu_torch.core import collectives
from wgmath_tpu_torch.dynamics.body import (
    Bodies,
    LocalMassProperties,
    Velocity,
    update_mprops,
)
from wgmath_tpu_torch.dynamics.constraint import Contacts
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.dynamics.solver import solve
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import PhysicsState, PipelineConfig
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase
from wgmath_tpu_torch.shapes.shape import (
    BALL,
    ShapeSet,
    ball_radii_or_nan,
    world_aabbs,
)


def body_mesh(n_devices: int | None = None,
              group=None) -> collectives.Shard:
    """The body axis over ``group`` (``None``: the default group; JAX's
    1-D mesh ``"b"``), which must be initialised already; ``n_devices``,
    where given, must be its rank count. Raises ``ValueError`` otherwise
    (``collectives.resolve``)."""
    import torch.distributed as dist

    if n_devices is None and dist.is_available() and dist.is_initialized():
        n_devices = dist.get_world_size(group)
    return collectives.resolve((group, n_devices))


def _body_fields(b: Bodies) -> list:
    mp = b.local_mprops
    return [b.poses.rotation, b.poses.translation, b.poses.scale,
            b.vels.linear, b.vels.angular, mp.inv_mass, mp.com,
            mp.inertia_ref_frame, mp.inv_principal_inertia, b.kinematic]


def _bodies_of(f: list) -> Bodies:
    return Bodies(Sim(f[0], f[1], f[2]), Velocity(f[3], f[4]),
                  LocalMassProperties(f[5], f[6], f[7], f[8]), f[9])


def _map_bodies(fn, b: Bodies) -> Bodies:
    return _bodies_of([None if x is None else fn(x)
                       for x in _body_fields(b)])


def _gather_bodies(local: Bodies, shard) -> Bodies:
    fields = _body_fields(local)
    some = [x for x in fields if x is not None]
    got = iter(collectives.gather_fields(some, shard))
    return _bodies_of([None if x is None else next(got) for x in fields])


def shard_state(state: PhysicsState,
                mesh: collectives.Shard) -> tuple[Bodies, ShapeSet]:
    """This rank's block of the bodies and the whole shape set, the body
    count padded to a multiple of the rank count. Padded slots are static
    (zero inverse mass) at the origin with the identity rotation and unit
    scale, each a zero-radius ball (the shape rows padded with zeros)."""
    n = state.bodies.num_bodies
    pad = (-n) % mesh.n

    def pad0(x):
        if pad == 0:
            return x
        return torch.cat([x, torch.zeros((pad,) + x.shape[1:],
                                         dtype=x.dtype, device=x.device)])

    bodies = _map_bodies(pad0, state.bodies)
    if pad:
        rot = bodies.poses.rotation.clone()
        rot[n:, -1] = 1.0
        scale = bodies.poses.scale.clone()
        scale[n:] = 1.0
        bodies = dataclasses.replace(bodies, poses=Sim(
            rot, bodies.poses.translation, scale))
    m = (n + pad) // mesh.n
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    local = _map_bodies(lambda x: x[rows], bodies)
    s = state.shapes
    shapes = ShapeSet(pad0(s.tag), pad0(s.params), s.vertices, s.indices,
                      s.cluster_min, s.cluster_max, kinds=s.kinds)
    return local, shapes


def make_sharded_step(mesh: collectives.Shard, params: SimParams,
                      config: PipelineConfig):
    """``fn(bodies_local, shapes) -> (bodies_local, pair_count)``: one
    step of the body-sharded pipeline on every rank of ``mesh``, with
    ``shard_state``'s blocks. ``pair_count`` is the pairs of every rank
    summed (a device scalar, the same on every rank)."""
    cap_local = max(config.pair_capacity // mesh.n, 64)

    def stepped(bodies_local: Bodies, shapes: ShapeSet):
        n_local = bodies_local.num_bodies
        off = mesh.rank * n_local
        rows = slice(off, off + n_local)
        bodies = _gather_bodies(bodies_local, mesh)
        mprops = update_mprops(bodies.poses, bodies.local_mprops)
        mins, maxs = world_aabbs(shapes, bodies.poses,
                                 margin=params.prediction_distance)
        radii = (ball_radii_or_nan(shapes, bodies.poses)
                 if BALL in shapes.kinds else None)
        pairs = find_pairs_partial(
            mins[rows], maxs[rows], off, mins, maxs, capacity=cap_local,
            block=config.broad_phase_block,
            max_per_row=config.broad_phase_max_per_row, ball_radius=radii,
            row_ball_radius=None if radii is None else radii[rows],
            margin=params.prediction_distance)
        c_local = narrow_phase(bodies.poses, shapes, pairs,
                               params.prediction_distance)
        names = [f.name for f in dataclasses.fields(Contacts)]
        contacts = Contacts(**dict(zip(names, collectives.gather_fields(
            [getattr(c_local, f) for f in names], mesh))))
        poses, vels, *_ = solve(
            bodies, mprops, contacts, params, max_colors=config.max_colors,
            warmstart_from=None, gs_cmax=0, use_jacobi=config.use_jacobi,
            max_per_body=config.max_per_body, stable_slots=False,
            shard=None if config.use_jacobi else mesh)
        new = Bodies(poses, vels, bodies.local_mprops, bodies.kinematic)
        total = collectives.all_reduce_sum(
            pairs.count.reshape(1).to(torch.int64).clone(), mesh)[0]
        return _map_bodies(lambda x: x[rows], new), total

    return stepped
