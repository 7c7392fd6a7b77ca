"""The port's whole step on mesh scenes against the JAX package's frames
stored in ``artifacts/mesh_jax.npz.xz`` (``JAX_PLATFORMS=cpu python
scripts/export_mesh_npz.py --only trimesh3|standalone`` rewrites them), so
this file makes no JAX step:

- ``SCENES["trimesh3"]`` (100 balls on a 450-triangle heightfield) under
  the testbed runner's configuration, three ``step_checked`` frames after
  the balls land, each from JAX's state before it: the counts and the
  configuration exactly, translations within 1e-5 m, velocities within
  ``tests/test_torch_pipeline_joints.py``'s limits;
- the standalone segment, triangle and convex scenes
  (``chip_smoke.standalone_scene``): the trail within 1e-5 m of JAX's
  every frame (5e-4 m for the polyhedron, whose EPA and GJK run in f32,
  C9: measured 8.7e-5 after 80 frames) and
  ``tests/test_standalone_shapes.py``'s rest checks;
- ``tests/test_physics.py``'s heightfield checks (balls and a box resting
  on a flat field) and ``tests/test_mesh_accel.py``'s 30 balls on the
  100,352-triangle field (the clustered route) for 10 frames, port only.

The JAX tests step the standalone scenes 80 frames and the heightfield
ones 120; here the first 40 (30 for the polyhedron) and 45: the rest
checks hold from frames 16, 13, 8, 27 and 36 on (measured), and each
frame costs 0.04-0.19 s on the CPU, the box's GJK running all its 32
iterations on a face-to-face contact. ``chip_smoke.py`` runs the whole
lengths on the card;
- ROADMAP C12, kept from the JAX package: pairs past
  ``mesh_pair_capacity`` are dropped without a count and the capacity is
  never regrown;
- ``chip_smoke.mesh10k_scene`` against the export's JAX builder, array for
  array; ``convert`` carrying a mesh state across exactly;
  ``auto_manifold_points`` on the new kinds against the JAX package's."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_pipeline_joints import (
    TR_TOL,
    VEL_TOL,
    case_config,
    case_params,
    case_state,
)
from wgmath_tpu_torch.convert import (
    load_arrays,
    state_from_arrays,
    state_to_arrays,
)
from wgmath_tpu_torch.dynamics.body import (
    Bodies,
    Velocity,
    ball_local_mprops,
    cuboid_local_mprops,
)
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import (
    PipelineConfig,
    auto_manifold_points,
    new_state,
    step,
    step_checked,
)
from wgmath_tpu_torch.scenes.builders import _merge_mprops
from wgmath_tpu_torch.shapes.mesh import heightfield
from wgmath_tpu_torch.shapes.shape import ShapeSet
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "mesh_jax.npz.xz")
CFG = PipelineConfig(pair_capacity=64, max_colors=4, manifold_points=1)


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _world(shapes, trans, mprops):
    n = len(trans)
    rot = torch.zeros((n, 4))
    rot[:, 3] = 1.0
    poses = Sim(rot, torch.tensor(trans, dtype=torch.float32),
                torch.ones(n))
    return new_state(Bodies(poses, Velocity.zero(n, device="cpu"), mprops),
                     shapes)


def _static(he):
    return cuboid_local_mprops(torch.tensor([he]),
                               dynamic=torch.tensor([False]))


@pytest.mark.parametrize("frame", range(3))
def test_trimesh3_frame_matches_jax(z, frame):
    prefix, cfg_key = (("warmed", "trimesh3.config_json") if frame == 0
                       else (f"ref.{frame - 1}.state",
                             f"trimesh3.ref.{frame - 1}.config_json"))
    state = case_state(z, "trimesh3", prefix)
    assert state.shapes.vertices.shape[0] == 256  # the 16 x 16 field
    got, got_cfg = step_checked(state, case_params(z, "trimesh3"),
                                case_config(z, cfg_key))
    ref = f"trimesh3.ref.{frame}."
    np.testing.assert_array_equal(got.pair_count.numpy(),
                                  z[ref + "pair_count"])
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(
        case_config(z, ref + "config_json"))
    assert int(got.pair_count[1]) > 100  # the balls rest on the field
    np.testing.assert_allclose(got.bodies.poses.translation.numpy(),
                               z[ref + "translation"], rtol=0, atol=TR_TOL)
    for field, tol in VEL_TOL.items():
        np.testing.assert_allclose(getattr(got.bodies.vels, field).numpy(),
                                   z[ref + field], rtol=0, atol=tol,
                                   err_msg=field)


@pytest.mark.parametrize("name, y_tol, trail_tol, frames", [
    ("triangle", 5e-3, 1e-5, 40), ("segment", 2e-2, 1e-5, 40),
    ("convex", 5e-3, 5e-4, 30)])
def test_standalone_scene_rests_as_jax(z, name, y_tol, trail_tol, frames):
    """A ball on a bare triangle and on a wire, a convex polyhedron on a
    slab: against JAX's trail every frame, then at rest."""
    from chip_smoke import standalone_scene

    state, cfg = standalone_scene(name, device="cpu")
    params = SimParams()
    trail = []
    for f in range(frames):
        state = step(state, params, cfg, warmstart=f > 0)
        trail.append(state.bodies.poses.translation[1].numpy())
    np.testing.assert_allclose(np.stack(trail),
                               z[f"standalone.{name}.trail"][:frames],
                               rtol=0, atol=trail_tol)
    assert abs(trail[-1][1] - 0.4) < y_tol
    assert float(torch.linalg.norm(state.bodies.vels.linear[1])) < 0.05


@pytest.mark.parametrize("body", ["balls", "box"])
def test_heightfield_rest_checks(body):
    """``tests/test_physics.py``'s two trimesh checks on the port: two
    balls of radius 0.4 come to rest on a flat 8 x 8 field at y = 0.4, a
    0.4-cube at its half extent plus the triangle margin (0.42)."""
    params = SimParams()
    if body == "balls":
        mesh = heightfield(np.zeros((9, 9), np.float32), device="cpu")
        state = _world(ShapeSet.concat(mesh, ShapeSet.balls(
            torch.tensor([0.4, 0.4]))),
            [[0.0, 0.0, 0.0], [-1.0, 1.0, 0.5], [1.3, 1.4, -0.7]],
            _merge_mprops(_static([4.5, 0.1, 4.5]),
                          ball_local_mprops(torch.tensor([0.4, 0.4]))))
        want, tol = np.full(2, 0.4), 0.03
    else:
        mesh = heightfield(np.zeros((7, 7), np.float32), device="cpu")
        he = torch.tensor([[0.4, 0.4, 0.4]])
        state = _world(ShapeSet.concat(mesh, ShapeSet.cuboids(he)),
                       [[0.0, 0.0, 0.0], [0.2, 1.2, -0.1]],
                       _merge_mprops(_static([3.5, 0.1, 3.5]),
                                     cuboid_local_mprops(he)))
        want, tol = np.asarray([0.42]), 0.05
    cfg = dataclasses.replace(CFG, mesh_pair_capacity=16, mesh_k_best=4)
    for _ in range(45):
        state, cfg = step_checked(state, params, cfg)
    np.testing.assert_allclose(state.bodies.poses.translation[1:, 1].numpy(),
                               want, atol=tol)
    assert float(state.bodies.vels.linear[1:].abs().max()) < 0.1


def test_100k_triangle_field_holds_30_balls():
    """``tests/test_mesh_accel.py``'s 30 balls of radius 0.15 on the 225 x
    225 field (100,352 triangles, the clustered route): 10 frames, none
    drops 0.02 m."""
    from tests.mesh_inputs import MESH10K_SPACING, field_heights
    from wgmath_tpu_torch.queries.mesh_accel import use_clusters

    n_grid, r, n_b = 225, 0.15, 30
    rng = np.random.default_rng(7)
    h = field_heights(n_grid, amp=0.5)
    mesh = heightfield(h, MESH10K_SPACING, MESH10K_SPACING, device="cpu")
    assert int(mesh.params[0, 3]) >= 100_000 and use_clusters(mesh)
    ii = rng.integers(10, n_grid - 10, n_b)
    jj = rng.integers(10, n_grid - 10, n_b)
    pos = np.stack([(ii - (n_grid - 1) / 2.0) * 0.2, h[ii, jj] + r + 0.001,
                    (jj - (n_grid - 1) / 2.0) * 0.2], -1).astype(np.float32)
    radii = torch.full((n_b,), r)
    state = _world(ShapeSet.concat(mesh, ShapeSet.balls(radii)),
                   np.concatenate([np.zeros((1, 3), np.float32), pos]),
                   _merge_mprops(_static([25.0, 1.0, 25.0]),
                                 ball_local_mprops(radii)))
    cfg = PipelineConfig(pair_capacity=256, contact_capacity=256,
                         mesh_pair_capacity=64, max_colors=8,
                         manifold_points=1)
    params = SimParams()
    for f in range(10):
        state = step(state, params, cfg, warmstart=f > 0)
    drop = pos[:, 1] - state.bodies.poses.translation[1:, 1].numpy()
    assert drop.max() < 0.02, drop.max()


def test_mesh_pair_capacity_drops_pairs_without_a_count():
    """ROADMAP C12, the JAX package's behaviour: eight balls on a field
    under ``mesh_pair_capacity`` 4. The broad phase finds eight mesh pairs,
    the step keeps contacts for the first four balls only, nothing counts
    the others, ``step_checked`` regrows nothing, and four balls fall
    through the field."""
    from wgmath_tpu_torch.broad_phase.brute_force import find_pairs
    from wgmath_tpu_torch.queries.mesh_contact import mesh_pair_demand
    from wgmath_tpu_torch.shapes.shape import world_aabbs

    mesh = heightfield(np.zeros((9, 9), np.float32), device="cpu")
    radii = torch.full((8,), 0.3)
    pos = np.zeros((9, 3), np.float32)
    pos[1:, 0] = np.linspace(-3.0, 3.0, 8)
    pos[1:, 1] = 0.301
    state = _world(ShapeSet.concat(mesh, ShapeSet.balls(radii)), pos,
                   _merge_mprops(_static([4.0, 0.1, 4.0]),
                                 ball_local_mprops(radii)))
    mn, mx = world_aabbs(state.shapes, state.bodies.poses, margin=0.002)
    demand = mesh_pair_demand(state.shapes, find_pairs(mn, mx, capacity=64))
    assert demand.tolist() == [8, 0]
    cfg = dataclasses.replace(CFG, mesh_pair_capacity=4)
    params = SimParams()
    for f in range(30):
        state, new_cfg = step_checked(state, params, cfg)
        assert new_cfg == cfg  # never regrown
        if f == 0:
            cons = state.prev_constraints
            rows = cons.valid[cfg.pair_capacity:]
            assert set(cons.body_a[cfg.pair_capacity:][rows].tolist()) == {
                1, 2, 3, 4}
            assert state.pair_count.tolist()[5:] == [0, 0, 0]
    y = state.bodies.poses.translation[1:, 1]
    assert (y[:4] > 0.25).all() and (y[4:] < 0.0).all()


def test_mesh10k_builders_agree():
    """``chip_smoke.mesh10k_scene`` (the port's constructors) and
    ``scripts/export_mesh_npz.py``'s (the JAX package's) give the same
    state, array for array."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import export_mesh_npz
    from chip_smoke import mesh10k_scene

    ours = state_to_arrays(mesh10k_scene(device="cpu"))
    theirs = state_to_arrays(export_mesh_npz.mesh10k_scene())
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["shapes.indices"].shape == (100_352, 3)
    assert len(ours["shapes.tag"]) == 10_001


def test_convert_carries_a_mesh_state_exactly(z):
    """A mesh state (vertices, indices and cluster boxes with it) through
    ``state_from_arrays`` and back, bit for bit."""
    arrays = {k[len("trimesh3.warmed."):]: v for k, v in z.items()
              if k.startswith("trimesh3.warmed.")}
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert arrays["shapes.cluster_min"].shape == (15, 3)


def test_auto_manifold_points_takes_the_new_kinds():
    """The support-mapped kinds widen the manifold as the JAX package's
    ``auto_manifold_points`` does; a trimesh with balls stays at 1."""
    import jax.numpy as jnp

    from wgmath_tpu.pipeline import auto_manifold_points as jax_auto
    from wgmath_tpu.shapes import shape as jshp
    from wgmath_tpu.shapes.mesh import heightfield as jheightfield
    from wgmath_tpu_torch.shapes.mesh import convex_polyhedron
    from tests.mesh_inputs import cube_corners
    from wgmath_tpu.shapes.mesh import convex_polyhedron as jconvex

    tri = [[[-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 0.0, 1.0]]]
    cases = [
        (lambda: ShapeSet.concat(heightfield(np.zeros((3, 3), np.float32),
                                             device="cpu"),
                                 ShapeSet.balls(torch.ones(2))),
         lambda: jshp.ShapeSet.concat(jheightfield(np.zeros((3, 3),
                                                            np.float32)),
                                      jshp.ShapeSet.balls(jnp.ones((2,))))),
        (lambda: ShapeSet.concat(ShapeSet.triangles(torch.tensor(tri)),
                                 ShapeSet.balls(torch.ones(1))),
         lambda: jshp.ShapeSet.concat(jshp.ShapeSet.triangles(tri),
                                      jshp.ShapeSet.balls(jnp.ones((1,))))),
        (lambda: ShapeSet.concat(ShapeSet.segments(torch.zeros(1, 3),
                                                   torch.ones(1, 3)),
                                 ShapeSet.balls(torch.ones(1))),
         lambda: jshp.ShapeSet.concat(
             jshp.ShapeSet.segments(np.zeros((1, 3)), np.ones((1, 3))),
             jshp.ShapeSet.balls(jnp.ones((1,))))),
        (lambda: ShapeSet.concat(ShapeSet.cuboids(torch.ones(1, 3)),
                                 convex_polyhedron(cube_corners(0.3),
                                                   device="cpu")),
         lambda: jshp.ShapeSet.concat(jshp.ShapeSet.cuboids(np.ones((1, 3))),
                                      jconvex(cube_corners(0.3)))),
    ]
    for ours, theirs in cases:
        o, t = ours(), theirs()
        for dyn in (None, [False, True], [True, False]):
            if dyn is not None:
                dyn = dyn + [True] * (o.num_shapes - len(dyn))
            assert auto_manifold_points(o, 3, dyn) == jax_auto(t, 3, dyn)
