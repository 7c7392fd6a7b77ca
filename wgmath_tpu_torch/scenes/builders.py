"""Scene builders (counterpart of ``wgmath_tpu/scenes/builders.py``:
``balls``, ``ball_pit``, ``boxes``, ``pyramid``,
``pyramid_levels_for_bodies``, ``keva_tower``, ``many_pyramids``,
``boxes_and_balls``, ``primitives3``, the jointed ``pendulum_chain``,
``joint_chain`` and ``ball_net3``, ``trimesh_scene``, the kinematic
``conveyor``, the 2D ``balls2d``, ``capsules2``, ``polyline2``,
``joint_net2`` and ``joint_prismatic2`` (``balls``, ``boxes`` and
``boxes_and_balls`` take ``dim=2``), and ``SCENES``, the JAX package's 25
entries in its order). Positions are computed in numpy
and jitter comes from numpy ``default_rng``, as in the JAX package, so
both build the same scene. Every builder takes ``device``; ``None`` means
the card."""

from __future__ import annotations

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import capacity_bucket, resolve_device
from wgmath_tpu_torch.dynamics.body import (
    Bodies,
    LocalMassProperties,
    Velocity,
    ball_local_mprops,
    capsule_local_mprops,
    cone_local_mprops,
    cuboid_local_mprops,
    cylinder_local_mprops,
)
from wgmath_tpu_torch.dynamics.joint import (
    fixed_joints,
    prismatic_joints,
    revolute_joints,
    spherical_joints,
)
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import PhysicsState, new_state
from wgmath_tpu_torch.shapes.shape import ShapeSet

_IDENTITY = (0.0, 0.0, 0.0, 1.0)


def _merge_mprops(*mp: LocalMassProperties) -> LocalMassProperties:
    return LocalMassProperties(
        *(None if getattr(mp[0], f) is None
          else torch.cat([getattr(m, f) for m in mp])
          for f in ("inv_mass", "com", "inertia_ref_frame",
                    "inv_principal_inertia")))


def _identity_rows(n: int, dim: int, dev) -> torch.Tensor:
    """``n`` identity rotations: quaternions (3D) or (cos, sin) (2D)."""
    return torch.tensor(_IDENTITY if dim == 3 else (1.0, 0.0),
                        device=dev).repeat(n, 1)


def _with_ground(shapes: ShapeSet, translations: torch.Tensor,
                 mprops: LocalMassProperties,
                 ground_he=(100.0, 1.0, 100.0),
                 rotations: torch.Tensor | None = None) -> PhysicsState:
    """A static ground cuboid (top face at y = 0) as body 0, then the
    bodies (the dimension is the translations'); ``rotations`` default to
    the identity."""
    dev = translations.device
    dim = translations.shape[1]
    ground_he = torch.tensor([ground_he[:dim]], dtype=torch.float32,
                             device=dev)
    all_shapes = ShapeSet.concat(ShapeSet.cuboids(ground_he), shapes)
    g_trans = torch.zeros((1, dim), device=dev)
    g_trans[0, 1] = -float(ground_he[0, 1])
    trans = torch.cat([g_trans, translations])
    n = trans.shape[0]
    rot = _identity_rows(n, dim, dev)
    if rotations is not None:
        rot[1:] = rotations
    poses = Sim(rot, trans, torch.ones(n, device=dev))
    mp = _merge_mprops(
        cuboid_local_mprops(ground_he,
                            dynamic=torch.tensor([False], device=dev)),
        mprops)
    return new_state(Bodies(poses, Velocity.zero(n, dim, device=dev), mp),
                     all_shapes)


def _centred(pos: np.ndarray) -> np.ndarray:
    """``pos`` less its mean on every axis but y, in place (the JAX
    package's ``pos -= pos.mean(0) * [1, 0, 1]``, ``[1, 0]`` in 2D)."""
    dim = pos.shape[1]
    pos -= pos.mean(0, keepdims=True) * np.asarray(
        [1.0, 0.0] + [1.0] * (dim - 2))
    return pos


def balls(n: int = 1000, *, radius: float = 0.5, dim: int = 3,
          seed: int = 0, device=None) -> PhysicsState:
    """Falling balls on a loose cubic (square, in 2D) lattice with seeded
    jitter, over the ground. ``device=None`` means the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spacing = 2.0 * radius * 1.05
    pos = _centred(_lattice(n, dim).astype(np.float32) * spacing)
    pos[:, 1] += 2.0 * radius
    pos += rng.uniform(-0.05, 0.05, pos.shape).astype(np.float32) * radius
    radii = torch.full((n,), radius, dtype=torch.float32, device=dev)
    return _with_ground(ShapeSet.balls(radii, dim=dim),
                        torch.from_numpy(pos).to(dev, torch.float32),
                        ball_local_mprops(radii, dim=dim))


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


def _boxes_state(pos: np.ndarray, half_extent: float, dev,
                 ground_he=(100.0, 1.0, 100.0)) -> PhysicsState:
    """Equal dynamic cubes (squares, for 2D ``pos``) over the ground."""
    he = torch.full((len(pos), pos.shape[1]), half_extent,
                    dtype=torch.float32, device=dev)
    return _with_ground(ShapeSet.cuboids(he),
                        torch.from_numpy(pos).to(dev, torch.float32),
                        cuboid_local_mprops(he), ground_he=ground_he)


def _lattice(n: int, dim: int) -> np.ndarray:
    """The first ``n`` points of the cubic lattice of side ceil(n^(1/dim))."""
    side = int(np.ceil(n ** (1.0 / dim)))
    return np.stack(np.meshgrid(*([np.arange(side)] * dim), indexing="ij"),
                    -1).reshape(-1, dim)[:n]


def boxes(n: int = 1000, *, half_extent: float = 0.5, dim: int = 3,
          seed: int = 0, device=None) -> PhysicsState:
    """Grid of falling cuboids with seeded jitter."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spacing = 2.0 * half_extent * 1.1
    pos = _centred(_lattice(n, dim).astype(np.float32) * spacing)
    pos[:, 1] += 2.0 * half_extent
    pos += rng.uniform(-0.02, 0.02, pos.shape).astype(np.float32)
    return _boxes_state(pos, half_extent, dev)


def _pyramid_positions(levels: int, he: float, cx: float = 0.0,
                       cz: float = 0.0) -> list:
    """Centres of a square pyramid of cubes: level l is (levels - l)² cubes
    on a 1.02 x cube-size grid, levels 1.01 x cube-size apart."""
    spacing = 2.0 * he * 1.02
    pos = []
    for lvl in range(levels):
        width = levels - lvl
        for i in range(width):
            for j in range(width):
                pos.append([cx + (i - width / 2.0 + 0.5) * spacing,
                            he + lvl * 2.0 * he * 1.01,
                            cz + (j - width / 2.0 + 0.5) * spacing])
    return pos


def pyramid(levels: int = 20, *, half_extent: float = 0.5,
            use_balls: bool = False, device=None) -> PhysicsState:
    """Square pyramid of cuboids (``use_balls``: of balls); 50 levels are
    42,925 bodies and the ground."""
    dev = resolve_device(device)
    he = half_extent
    pos = np.asarray(_pyramid_positions(levels, he), np.float32)
    if not use_balls:
        return _boxes_state(pos, he, dev)
    radii = torch.full((len(pos),), he, dtype=torch.float32, device=dev)
    return _with_ground(ShapeSet.balls(radii),
                        torch.from_numpy(pos).to(dev, torch.float32),
                        ball_local_mprops(radii))


def pyramid_levels_for_bodies(target: int) -> int:
    """Smallest level count whose pyramid has >= target bodies."""
    for lv in range(1, 80):
        if sum((lv - k) ** 2 for k in range(lv)) >= target:
            return lv
    return 80


def keva_tower(levels: int = 8, per_level: int = 4, *,
               device=None) -> PhysicsState:
    """Plank tower, each level turned 90° about y from the one below."""
    dev = resolve_device(device)
    plank = np.asarray([0.9, 0.1, 0.3], np.float32)  # half extents
    q_id = np.asarray(_IDENTITY, np.float32)
    q_90 = np.asarray([0.0, np.sin(np.pi / 4), 0, np.cos(np.pi / 4)],
                      np.float32)
    pos, rots = [], []
    for lvl in range(levels):
        rotated = lvl % 2 == 1
        for i in range(per_level):
            off = (i - (per_level - 1) / 2.0) * 0.7
            y = plank[1] + lvl * 2.02 * plank[1]
            pos.append([off, y, 0.0] if rotated else [0.0, y, off])
            rots.append(q_90 if rotated else q_id)
    he = torch.from_numpy(plank).to(dev).repeat(len(pos), 1)
    return _with_ground(
        ShapeSet.cuboids(he),
        torch.from_numpy(np.asarray(pos, np.float32)).to(dev),
        cuboid_local_mprops(he), ground_he=(20.0, 1.0, 20.0),
        rotations=torch.from_numpy(np.stack(rots)).to(dev))


def many_pyramids(count: int = 4, levels: int = 10, *,
                  device=None) -> PhysicsState:
    """``count`` pyramids of cubes on a square grid."""
    dev = resolve_device(device)
    he = 0.5
    grid = int(np.ceil(np.sqrt(count)))
    extent = levels * (2.0 * he * 1.02) * 1.5
    pos, k = [], 0
    for gx in range(grid):
        for gz in range(grid):
            if k >= count:
                break
            k += 1
            pos += _pyramid_positions(levels, he,
                                      (gx - (grid - 1) / 2.0) * extent,
                                      (gz - (grid - 1) / 2.0) * extent)
    return _boxes_state(np.asarray(pos, np.float32), he, dev,
                        ground_he=(200.0, 1.0, 200.0))


def boxes_and_balls(n: int = 400, *, dim: int = 3,
                    device=None) -> PhysicsState:
    """Balls then boxes on one jittered lattice over the ground."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    half = n // 2
    r, he = 0.5, 0.5
    radii = torch.full((half,), r, dtype=torch.float32, device=dev)
    hes = torch.full((n - half, dim), he, dtype=torch.float32, device=dev)
    shapes = ShapeSet.concat(ShapeSet.balls(radii, dim=dim),
                             ShapeSet.cuboids(hes))
    mp = _merge_mprops(ball_local_mprops(radii, dim=dim),
                       cuboid_local_mprops(hes))
    pos = _centred(_lattice(n, dim).astype(np.float32) * 1.15)
    pos[:, 1] += 1.0
    pos += rng.uniform(-0.03, 0.03, pos.shape).astype(np.float32)
    return _with_ground(shapes, torch.from_numpy(pos).to(dev), mp)


def primitives3(per_kind: int = 40, *, device=None) -> PhysicsState:
    """A rain of primitives over the ground: ``per_kind`` balls, then as
    many cuboids, capsules, cylinders and cones, on one jittered lattice
    1.4 m apart whose lowest layer starts 1.5 m up (every support-mapped
    pair of the narrow phase)."""
    dev = resolve_device(device)
    n = per_kind
    r, hh, he = 0.4, 0.3, 0.4

    def full(*shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    shapes = ShapeSet.concat(
        ShapeSet.balls(full(n, v=r)), ShapeSet.cuboids(full(n, 3, v=he)),
        ShapeSet.capsules(full(n, v=hh), full(n, v=r)),
        ShapeSet.cylinders(full(n, v=hh), full(n, v=r)),
        ShapeSet.cones(full(n, v=hh), full(n, v=r)))
    mp = _merge_mprops(
        ball_local_mprops(full(n, v=r)),
        cuboid_local_mprops(full(n, 3, v=he)),
        capsule_local_mprops(full(n, v=hh), full(n, v=r)),
        cylinder_local_mprops(full(n, v=hh), full(n, v=r)),
        cone_local_mprops(full(n, v=hh), full(n, v=r)))
    rng = np.random.default_rng(7)
    pos = _lattice(5 * n, 3).astype(np.float32) * 1.4
    pos -= pos.mean(0, keepdims=True) * np.asarray([1.0, 0.0, 1.0])
    pos[:, 1] += 1.5
    pos += rng.uniform(-0.05, 0.05, pos.shape).astype(np.float32)
    return _with_ground(shapes, torch.from_numpy(pos).to(dev), mp)


def trimesh_scene(n_balls: int = 100, *, device=None) -> PhysicsState:
    """Balls of radius 0.3 raining on a bumpy 16 x 16 heightfield (450
    triangles, the static body 0): ``n_balls`` on a square lattice 0.75 m
    apart, 3-5 m up (the reference's trimesh3 demo)."""
    from wgmath_tpu_torch.shapes.mesh import heightfield

    dev = resolve_device(device)
    rng = np.random.default_rng(4)
    xs = np.linspace(-2 * np.pi, 2 * np.pi, 16)
    hills = (np.sin(xs)[:, None] * np.cos(xs)[None, :]).astype(np.float32)
    r = 0.3
    radii = torch.full((n_balls,), r, dtype=torch.float32, device=dev)
    shapes = ShapeSet.concat(heightfield(hills, 1.0, 1.0, device=dev),
                             ShapeSet.balls(radii))
    side = int(np.ceil(np.sqrt(n_balls)))
    coords = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                  indexing="ij"), -1).reshape(-1, 2)[:n_balls]
    pos = np.zeros((n_balls + 1, 3), np.float32)
    pos[1:, [0, 2]] = (coords - side / 2.0) * 2.5 * r
    pos[1:, 1] = 3.0 + rng.uniform(0, 2, n_balls)
    n = n_balls + 1
    poses = Sim(torch.tensor(_IDENTITY, device=dev).repeat(n, 1),
                torch.from_numpy(pos).to(dev), torch.ones(n, device=dev))
    mp = _merge_mprops(
        cuboid_local_mprops(torch.tensor([[8.0, 1.0, 8.0]], device=dev),
                            dynamic=torch.tensor([False], device=dev)),
        ball_local_mprops(radii))
    return new_state(Bodies(poses, Velocity.zero(n, device=dev), mp), shapes)


def _ball_chain(links: int, dev):
    """``links`` + 1 balls of radius 0.2, 1 m apart along +x, the first
    one static: (bodies, shapes, dynamic mask, body_a, body_b, anchors_a,
    anchors_b) of a chain whose joints sit at the midpoints."""
    n = links + 1
    r = torch.full((n,), 0.2, device=dev)
    trans = torch.zeros((n, 3), device=dev)
    trans[:, 0] = torch.arange(n, device=dev, dtype=torch.float32)
    dynamic = np.ones(n, bool)
    dynamic[0] = False
    mp = ball_local_mprops(r, dynamic=torch.from_numpy(dynamic).to(dev))
    rot = torch.tensor(_IDENTITY, device=dev).repeat(n, 1)
    bodies = Bodies(Sim(rot, trans, torch.ones(n, device=dev)),
                    Velocity.zero(n, device=dev), mp)
    return (bodies, ShapeSet.balls(r), dynamic, list(range(links)),
            list(range(1, n)), [[0.5, 0.0, 0.0]] * links,
            [[-0.5, 0.0, 0.0]] * links)


def pendulum_chain(links: int = 8, *, joint: str = "spherical",
                   device=None) -> PhysicsState:
    """A chain of balls hanging from a static anchor, linked by spherical
    or revolute (about z) joints."""
    dev = resolve_device(device)
    bodies, shapes, dynamic, ba, bb, aa, ab = _ball_chain(links, dev)
    if joint == "revolute":
        joints = revolute_joints(ba, bb, aa, ab,
                                 axes=[[0.0, 0.0, 1.0]] * links,
                                 dynamic_mask=dynamic, device=dev)
    else:
        joints = spherical_joints(ba, bb, aa, ab, dynamic_mask=dynamic,
                                  device=dev)
    return new_state(bodies, shapes, joints)


def joint_chain(links: int = 8, *, joint: str = "fixed",
                device=None) -> PhysicsState:
    """A chain of balls under fixed joints, or prismatic ones sliding
    along y within (-0.5, 0.5)."""
    dev = resolve_device(device)
    bodies, shapes, dynamic, ba, bb, aa, ab = _ball_chain(links, dev)
    if joint == "prismatic":
        joints = prismatic_joints(ba, bb, aa, ab,
                                  axes=[[0.0, 1.0, 0.0]] * links,
                                  limits=(-0.5, 0.5), dynamic_mask=dynamic,
                                  device=dev)
    else:
        joints = fixed_joints(ba, bb, aa, ab, dynamic_mask=dynamic,
                              device=dev)
    return new_state(bodies, shapes, joints)


def ball_net3(nk: int = 100, ni: int = 100, *, radius: float = 0.25,
              spacing: float = 0.6, height: float = 8.0,
              device=None) -> PhysicsState:
    """An ``nk`` x ``ni`` net of balls ``height`` m up, each joined to its
    four neighbours by spherical joints at the midpoints, draping over a
    static dome (a ball of radius 5 centred 1 m up) onto the ground. The
    ground and the dome come first; 100 x 100 is 10,002 bodies and 19,800
    joints."""
    dev = resolve_device(device)
    n = nk * ni
    ks, is_ = np.meshgrid(np.arange(nk), np.arange(ni), indexing="ij")
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = (ks.reshape(-1) - (nk - 1) / 2.0) * spacing
    pos[:, 2] = (is_.reshape(-1) - (ni - 1) / 2.0) * spacing
    pos[:, 1] = height
    h = spacing / 2.0
    body_a, body_b, anch_a, anch_b = [], [], [], []
    for k in range(nk):
        for i in range(ni):
            if k > 0:  # along x
                body_a.append((k - 1) * ni + i)
                body_b.append(k * ni + i)
                anch_a.append([h, 0.0, 0.0])
                anch_b.append([-h, 0.0, 0.0])
            if i > 0:  # along z
                body_a.append(k * ni + i - 1)
                body_b.append(k * ni + i)
                anch_a.append([0.0, 0.0, h])
                anch_b.append([0.0, 0.0, -h])
    dome = torch.tensor([5.0], device=dev)
    radii = torch.full((n,), radius, device=dev)
    shapes = ShapeSet.concat(ShapeSet.balls(dome), ShapeSet.balls(radii))
    mp = _merge_mprops(
        ball_local_mprops(dome, dynamic=torch.zeros(1, dtype=torch.bool,
                                                    device=dev)),
        ball_local_mprops(radii))
    trans = torch.from_numpy(np.concatenate(
        [np.asarray([[0.0, 1.0, 0.0]], np.float32), pos])).to(dev)
    base = _with_ground(shapes, trans, mp)
    n_static = 2  # the ground and the dome lead the body table
    dynamic = np.concatenate([np.zeros(n_static, bool), np.ones(n, bool)])
    joints = spherical_joints([b + n_static for b in body_a],
                              [b + n_static for b in body_b], anch_a,
                              anch_b, dynamic_mask=dynamic, device=dev)
    return new_state(base.bodies, base.shapes, joints)


def capsules2(n: int = 100, *, device=None) -> PhysicsState:
    """2D capsules then balls raining on the ground (the 2D support-mapped
    narrow phase)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(13)
    half = n // 2
    hh, r = 0.3, 0.2

    def full(k, v):
        return torch.full((k,), v, dtype=torch.float32, device=dev)

    shapes = ShapeSet.concat(
        ShapeSet.capsules(full(half, hh), full(half, r), dim=2),
        ShapeSet.balls(full(n - half, r), dim=2))
    mp = _merge_mprops(
        capsule_local_mprops(full(half, hh), full(half, r), dim=2),
        ball_local_mprops(full(n - half, r), dim=2))
    pos = np.zeros((n, 2), np.float32)
    pos[:, 0] = rng.uniform(-8, 8, n)
    pos[:, 1] = rng.uniform(1.5, 10, n)
    return _with_ground(shapes, torch.from_numpy(pos).to(dev), mp,
                        ground_he=(12.0, 1.0))


def polyline2(n: int = 200, *, device=None) -> PhysicsState:
    """2D balls then boxes raining on a jagged polyline terrain (41
    vertices of 1.5·sin(0.6x) over [-20, 20], the static body 0)."""
    from wgmath_tpu_torch.shapes.mesh import polyline

    dev = resolve_device(device)
    rng = np.random.default_rng(11)
    xs = np.linspace(-20.0, 20.0, 41)
    ys = np.sin(xs * 0.6) * 1.5
    terrain = polyline(np.stack([xs, ys], -1).astype(np.float32),
                       device=dev)
    half = n // 2
    r, he = 0.3, 0.3
    radii = torch.full((half,), r, dtype=torch.float32, device=dev)
    hes = torch.full((n - half, 2), he, dtype=torch.float32, device=dev)
    shapes = ShapeSet.concat(terrain, ShapeSet.balls(radii, dim=2),
                             ShapeSet.cuboids(hes))
    pos = np.zeros((n, 2), np.float32)
    pos[:, 0] = rng.uniform(-15, 15, n)
    pos[:, 1] = rng.uniform(4, 14, n)
    trans = torch.from_numpy(np.concatenate(
        [np.zeros((1, 2), np.float32), pos])).to(dev)
    total = n + 1
    mp = _merge_mprops(
        cuboid_local_mprops(torch.tensor([[20.0, 2.0]], device=dev),
                            dynamic=torch.tensor([False], device=dev)),
        ball_local_mprops(radii, dim=2), cuboid_local_mprops(hes))
    poses = Sim(_identity_rows(total, 2, dev), trans,
                torch.ones(total, device=dev))
    return new_state(Bodies(poses, Velocity.zero(total, 2, device=dev), mp),
                     shapes)


def joint_net2(nk: int = 12, ni: int = 12, *, joint: str = "revolute",
               device=None) -> PhysicsState:
    """A 2D ``nk`` x ``ni`` net of balls (radius 0.4, 1 m apart) linked to
    their right and lower neighbours by revolute joints at the upper /
    left ball's centre, the outer fifths of the top row static; or by
    fixed joints with the left column static, the net cantilevered off
    it. 100 x 100 revolute is 10,000 balls and 19,800 joints."""
    dev = resolve_device(device)
    shift, r = 1.0, 0.4
    n = nk * ni
    pos = np.zeros((n, 2), np.float32)
    dynamic = np.ones(n, bool)
    body_a, body_b, anch_a, anch_b = [], [], [], []
    for k in range(nk):
        for i in range(ni):
            pos[k * ni + i] = (k * shift, -i * shift)
            if joint == "revolute":
                if i == 0 and (k < nk // 5 or k >= (4 * nk) // 5):
                    dynamic[k * ni + i] = False
            elif k == 0:
                dynamic[k * ni + i] = False
            if i > 0:  # the vertical link, its pivot the parent's centre
                body_a.append(k * ni + i - 1)
                body_b.append(k * ni + i)
                anch_a.append([0.0, 0.0])
                anch_b.append([0.0, shift])
            if k > 0:  # the horizontal link
                body_a.append((k - 1) * ni + i)
                body_b.append(k * ni + i)
                anch_a.append([0.0, 0.0])
                anch_b.append([-shift, 0.0])
    radii = torch.full((n,), r, dtype=torch.float32, device=dev)
    poses = Sim(_identity_rows(n, 2, dev), torch.from_numpy(pos).to(dev),
                torch.ones(n, device=dev))
    mp = ball_local_mprops(radii, dim=2,
                           dynamic=torch.from_numpy(dynamic).to(dev))
    bodies = Bodies(poses, Velocity.zero(n, 2, device=dev), mp)
    make = revolute_joints if joint == "revolute" else fixed_joints
    joints = make(body_a, body_b, anch_a, anch_b, dim=2,
                  dynamic_mask=dynamic, device=dev)
    return new_state(bodies, ShapeSet.balls(radii, dim=2), joints)


def joint_prismatic2(chains: int = 4, num: int = 6, *,
                     device=None) -> PhysicsState:
    """2D prismatic chains: ``num`` boxes under each static head box,
    sliding along alternating diagonals within (-1.5, 1.5)."""
    dev = resolve_device(device)
    shift, he = 1.0, 0.4
    per = num + 1
    n = chains * per
    pos = np.zeros((n, 2), np.float32)
    dynamic = np.ones(n, bool)
    body_a, body_b, anch_a, anch_b, axes = [], [], [], [], []
    s = 2.0 ** -0.5
    for c in range(chains):
        head = c * per
        pos[head] = (c * shift * 4.0, 0.0)
        dynamic[head] = False
        for i in range(num):
            pos[head + 1 + i] = (c * shift * 4.0, -(i + 1) * shift)
            body_a.append(head + i)
            body_b.append(head + 1 + i)
            anch_a.append([0.0, 0.0])
            anch_b.append([0.0, shift])
            axes.append([s, s] if i % 2 == 0 else [-s, s])
    hes = torch.full((n, 2), he, dtype=torch.float32, device=dev)
    poses = Sim(_identity_rows(n, 2, dev), torch.from_numpy(pos).to(dev),
                torch.ones(n, device=dev))
    mp = cuboid_local_mprops(hes, dynamic=torch.from_numpy(dynamic).to(dev))
    bodies = Bodies(poses, Velocity.zero(n, 2, device=dev), mp)
    joints = prismatic_joints(body_a, body_b, anch_a, anch_b, axes,
                              limits=(-1.5, 1.5), dim=2,
                              dynamic_mask=dynamic, device=dev)
    return new_state(bodies, ShapeSet.cuboids(hes), joints)


def box_configs(n_bodies: int) -> dict:
    """The 4-point ``ladder`` and ``fused`` configurations the box scenes
    are stepped under, as ``PipelineConfig`` field dicts: the JAX package's
    own recipe (``tests/test_gs_fused.py::test_pipeline_gs_fused_boxes_p4``)
    with the budgets of ``scripts/run_pyramid43k.py`` (grid budgets 216 /
    16 / 32 / 128, ``gs_cmax`` 8192, 24 colours), the capacities seeded
    from the body count: 6 pairs, 3 contacts and 6 cuboid pairs a body, as
    that script's 262,144 / 131,072 / 131,072 are at 42,926 bodies."""
    ladder = dict(
        pair_capacity=capacity_bucket(6 * n_bodies),
        contact_capacity=capacity_bucket(3 * n_bodies),
        max_colors=24, gs_cmax=8192, bp_slack=0.03, bp_algo="grid",
        sat_pair_capacity=capacity_bucket(6 * n_bodies, floor=256),
        bc_pair_capacity=256, bp_cand_budget=216, bp_cell_cap=16,
        bp_global_cap=32, broad_phase_max_per_row=128, manifold_points=4,
        gs_windows=(256,) * 24)
    return {"ladder": ladder,
            "fused": dict(ladder, gs_fused=True, gs_rung0=256)}


def primitive_configs(n_bodies: int) -> dict:
    """:func:`box_configs` with the support-mapped pairs compacted into a
    ``pfm_pair_capacity`` of 6 a body (at least 256): the configurations
    ``primitives3`` is stepped under."""
    pfm = capacity_bucket(6 * n_bodies, floor=256)
    return {name: dict(cfg, pfm_pair_capacity=pfm)
            for name, cfg in box_configs(n_bodies).items()}


def balls2d(n: int = 300, *, device=None) -> PhysicsState:
    """``balls(n, dim=2)``: falling discs over the ground."""
    return balls(n, dim=2, device=device)


def conveyor(n_balls: int = 48, *, speed: float = 1.0, radius: float = 0.4,
             device=None) -> PhysicsState:
    """A kinematic platform (one-way coupling) dragging a grid of dynamic
    balls: body 0 the static ground slab, body 1 the platform, with zero
    inverse mass and a prescribed +x velocity of ``speed`` that enters
    every contact's relative velocity, so friction spins the resting balls
    up toward the belt's speed while the platform's pose integrates at
    exactly ``speed``·t. Statics and kinematics come first.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    plat_he = np.asarray([[6.0, 0.25, 4.0]], np.float32)
    ground_he = np.asarray([[40.0, 1.0, 40.0]], np.float32)
    side = int(np.ceil(np.sqrt(n_balls)))
    xs, zs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    grid = np.stack([xs, zs], -1).reshape(-1, 2)[:n_balls]
    spacing = 2.0 * radius * 1.1
    pos = np.zeros((n_balls, 3), np.float32)
    pos[:, [0, 2]] = (grid - grid.mean(0, keepdims=True)) * spacing
    # the balls rest about on the belt (the platform's top at y = 1.5)
    pos[:, 1] = 1.5 + radius * 1.02
    he = torch.from_numpy(np.concatenate([ground_he, plat_he])).to(dev)
    radii = torch.full((n_balls,), radius, dtype=torch.float32, device=dev)
    shapes = ShapeSet.concat(ShapeSet.cuboids(he), ShapeSet.balls(radii))
    trans = torch.from_numpy(np.concatenate([
        np.asarray([[0.0, -1.0, 0.0], [0.0, 1.25, 0.0]], np.float32),
        pos])).to(dev)
    n = n_balls + 2
    poses = Sim(_identity_rows(n, 3, dev), trans, torch.ones(n, device=dev))
    mp = _merge_mprops(
        cuboid_local_mprops(he, dynamic=torch.zeros(2, dtype=torch.bool,
                                                    device=dev)),
        ball_local_mprops(radii))
    vels = Velocity.zero(n, 3, device=dev)
    vels.linear[1, 0] = speed
    kin = torch.zeros(n, dtype=torch.bool, device=dev)
    kin[1] = True
    return new_state(Bodies(poses, vels, mp, kin), shapes)


# the JAX package's scenes, in its order (``--list`` prints them so);
# each takes ``device``
SCENES = {
    "balls3": lambda device=None: balls(1000, device=device),
    "boxes3": lambda device=None: boxes(1000, device=device),
    "pyramid3": lambda device=None: pyramid(20, device=device),
    "ball_pyramid3": lambda device=None: pyramid(20, use_balls=True,
                                                 device=device),
    "balls10k": lambda device=None: balls(10_000, device=device),
    "ball_pit": lambda device=None: ball_pit(10_000, device=device),
    "keva3": lambda device=None: keva_tower(device=device),
    "many_pyramids3": lambda device=None: many_pyramids(device=device),
    "joint_ball3": lambda device=None: pendulum_chain(
        8, joint="spherical", device=device),
    "joint_revolute3": lambda device=None: pendulum_chain(
        8, joint="revolute", device=device),
    "trimesh3": lambda device=None: trimesh_scene(device=device),
    "balls2": lambda device=None: balls2d(device=device),
    "pyramid2": lambda device=None: boxes(200, dim=2, device=device),
    "conveyor3": lambda device=None: conveyor(device=device),
    "capsules2": lambda device=None: capsules2(device=device),
    "primitives3": lambda device=None: primitives3(device=device),
    "boxes_and_balls3": lambda device=None: boxes_and_balls(
        400, dim=3, device=device),
    "boxes_and_balls2": lambda device=None: boxes_and_balls(
        200, dim=2, device=device),
    "polyline2": lambda device=None: polyline2(device=device),
    "joint_fixed3": lambda device=None: joint_chain(8, joint="fixed",
                                                    device=device),
    "joint_prismatic3": lambda device=None: joint_chain(
        6, joint="prismatic", device=device),
    "joint_ball2": lambda device=None: joint_net2(12, 12, joint="revolute",
                                                  device=device),
    "joint_fixed2": lambda device=None: joint_net2(8, 8, joint="fixed",
                                                   device=device),
    "joint_prismatic2": lambda device=None: joint_prismatic2(device=device),
    "ball_net3": lambda device=None: ball_net3(16, 16, device=device),
}
# the 2D entries of SCENES (the JAX package registers eight)
PLANAR_SCENES = ("balls2", "pyramid2", "boxes_and_balls2", "capsules2",
                 "polyline2", "joint_ball2", "joint_fixed2",
                 "joint_prismatic2")
