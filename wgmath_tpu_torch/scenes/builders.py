"""Scene builders (counterpart of ``wgmath_tpu/scenes/builders.py``:
``ball_pit``). Jitter comes from numpy ``default_rng(seed)``, as in the JAX
package, so both build the same scene."""

from __future__ import annotations

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.dynamics.body import (
    Bodies,
    LocalMassProperties,
    Velocity,
    ball_local_mprops,
    cuboid_local_mprops,
)
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import PhysicsState, new_state
from wgmath_tpu_torch.shapes.shape import ShapeSet


def _merge_mprops(*mp: LocalMassProperties) -> LocalMassProperties:
    return LocalMassProperties(
        *(torch.cat([getattr(m, f) for m in mp])
          for f in ("inv_mass", "com", "inertia_ref_frame",
                    "inv_principal_inertia")))


def _with_ground(shapes: ShapeSet, translations: torch.Tensor,
                 mprops: LocalMassProperties,
                 ground_he=(100.0, 1.0, 100.0)) -> PhysicsState:
    dev = translations.device
    ground_he = torch.tensor([ground_he], dtype=torch.float32, device=dev)
    all_shapes = ShapeSet.concat(ShapeSet.cuboids(ground_he), shapes)
    g_trans = torch.zeros((1, 3), device=dev)
    g_trans[0, 1] = -float(ground_he[0, 1])
    trans = torch.cat([g_trans, translations])
    n = trans.shape[0]
    rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
    poses = Sim(rot, trans, torch.ones(n, device=dev))
    mp = _merge_mprops(
        cuboid_local_mprops(ground_he,
                            dynamic=torch.tensor([False], device=dev)),
        mprops)
    return new_state(Bodies(poses, Velocity.zero(n, device=dev), mp),
                     all_shapes)


def ball_pit(n: int = 10_000, *, radius: float = 0.5, depth: int = 8,
             seed: int = 0, device=None) -> PhysicsState:
    """Lattice of balls dropped into a walled pit (ground + 4 static walls,
    statics first). ``device=None`` means the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spacing = 2.0 * radius * 1.05
    side = int(np.ceil(np.sqrt(n / depth)))
    coords = np.stack(np.meshgrid(np.arange(side), np.arange(depth),
                                  np.arange(side), indexing="ij"),
                      -1).reshape(-1, 3)[:n]
    pos = coords[:, [0, 1, 2]].astype(np.float32) * spacing
    pos[:, [0, 2]] -= pos[:, [0, 2]].mean(0, keepdims=True)
    pos[:, 1] += 2.0 * radius
    pos += rng.uniform(-0.05, 0.05, pos.shape).astype(np.float32) * radius
    half_w = side * spacing / 2.0 + 2.0 * radius
    wall_t = 0.5
    wall_h = depth * spacing / 2.0 + 4.0
    wall_he = np.asarray([
        [wall_t, wall_h, half_w + 2 * wall_t],
        [wall_t, wall_h, half_w + 2 * wall_t],
        [half_w + 2 * wall_t, wall_h, wall_t],
        [half_w + 2 * wall_t, wall_h, wall_t],
    ], np.float32)
    wall_pos = np.asarray([
        [half_w + wall_t, wall_h, 0.0],
        [-half_w - wall_t, wall_h, 0.0],
        [0.0, wall_h, half_w + wall_t],
        [0.0, wall_h, -half_w - wall_t],
    ], np.float32)
    wall_he_t = torch.from_numpy(wall_he).to(dev)
    radii = torch.full((n,), radius, dtype=torch.float32, device=dev)
    shapes = ShapeSet.concat(ShapeSet.cuboids(wall_he_t),
                             ShapeSet.balls(radii))
    mp = _merge_mprops(
        cuboid_local_mprops(wall_he_t, dynamic=torch.zeros(
            4, dtype=torch.bool, device=dev)),
        ball_local_mprops(radii))
    trans = torch.from_numpy(np.concatenate([wall_pos, pos])).to(
        dev, torch.float32)
    return _with_ground(shapes, trans, mp,
                        ground_he=(half_w + 4.0, 1.0, half_w + 4.0))
