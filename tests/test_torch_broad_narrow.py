"""The port's broad phase (grid and brute force) and narrow phase against
the JAX package on the same seeded inputs. Pair lists, counts, validity and
point counts must match exactly; contact geometry to float32 rounding."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgmath_tpu.broad_phase.brute_force import PairList as JaxPairList
from wgmath_tpu.broad_phase.brute_force import find_pairs as jax_find_pairs
from wgmath_tpu.broad_phase.grid import find_pairs_grid as jax_grid
from wgmath_tpu.queries.narrow_phase import narrow_phase as jax_narrow
from wgmath_tpu.scenes.builders import ball_pit as jax_ball_pit
from wgmath_tpu_torch.broad_phase.brute_force import PairList, find_pairs
from wgmath_tpu_torch.broad_phase.grid import find_pairs_grid
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase
from wgmath_tpu_torch.scenes.builders import ball_pit
from wgmath_tpu_torch.shapes import shape as shp
from tests.torch_threads import one_torch_thread  # noqa: F401

PRED = 0.002


def _boxes(seed, n=400):
    """Balls (and a few small boxes) in a cube over one huge static slab:
    the slab is the grid's outlier/global body."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    he = np.repeat(rng.uniform(0.3, 0.6, (n, 1)), 3, 1).astype(np.float32)
    radius = he[:, 0].copy()
    cub = rng.random(n) < 0.1
    he[cub] = rng.uniform(0.2, 0.6, (int(cub.sum()), 3))
    radius[cub] = np.nan
    center[0], he[0], radius[0] = (0.0, -5.0, 0.0), (40.0, 1.0, 40.0), np.nan
    dynamic = rng.random(n) > 0.05
    dynamic[0] = False
    return (center - he, center + he, radius, dynamic)


def _pairs_equal(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.body_a.numpy()[v],
                                  np.asarray(want.body_a)[v])
    np.testing.assert_array_equal(got.body_b.numpy()[v],
                                  np.asarray(want.body_b)[v])
    assert int(got.count) == int(want.count)


def _set(p):
    v = np.asarray(p.valid)
    return set(zip(np.asarray(p.body_a)[v].tolist(),
                   np.asarray(p.body_b)[v].tolist()))


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_pairs_match_jax_and_brute_force(seed):
    mins, maxs, radius, dyn = _boxes(seed)
    kw = dict(capacity=4096, max_per_body=32, cell_cap=16, global_cap=8,
              cand_budget=96)
    want = jax_grid(jnp.asarray(mins), jnp.asarray(maxs),
                    ball_radius=jnp.asarray(radius), margin=PRED,
                    dynamic=jnp.asarray(dyn), **kw)
    got = find_pairs_grid(torch.from_numpy(mins), torch.from_numpy(maxs),
                          ball_radius=torch.from_numpy(radius), margin=PRED,
                          dynamic=torch.from_numpy(dyn), **kw)
    _pairs_equal(got, want)
    assert int(want.count) > 100
    # the brute-force pass is the grid's oracle: same pair set
    brute = jax_find_pairs(jnp.asarray(mins), jnp.asarray(maxs),
                           capacity=4096, max_per_row=64,
                           ball_radius=jnp.asarray(radius), margin=PRED,
                           dynamic=jnp.asarray(dyn))
    assert _set(got) == _set(brute)
    tb = find_pairs(torch.from_numpy(mins), torch.from_numpy(maxs),
                    capacity=4096, max_per_row=64, block=128,
                    ball_radius=torch.from_numpy(radius), margin=PRED,
                    dynamic=torch.from_numpy(dyn))
    _pairs_equal(tb, brute)


@pytest.mark.parametrize("budget", ["cell_cap", "cand_budget", "global_cap",
                                    "max_per_body", "capacity"])
def test_grid_overflow_signal_matches_jax(budget):
    """A budget that is too small flips the count negative (capacity
    overflow keeps it positive, above the capacity), exactly as in JAX."""
    mins, maxs, radius, dyn = _boxes(2)
    kw = dict(capacity=4096, max_per_body=32, cell_cap=16, global_cap=8,
              cand_budget=96)
    kw[budget] = {"cell_cap": 2, "cand_budget": 8, "global_cap": 0,
                  "max_per_body": 2, "capacity": 64}[budget]
    want = jax_grid(jnp.asarray(mins), jnp.asarray(maxs),
                    ball_radius=jnp.asarray(radius), margin=PRED,
                    dynamic=jnp.asarray(dyn), **kw)
    got = find_pairs_grid(torch.from_numpy(mins), torch.from_numpy(maxs),
                          ball_radius=torch.from_numpy(radius), margin=PRED,
                          dynamic=torch.from_numpy(dyn), **kw)
    _pairs_equal(got, want)
    if budget == "capacity":
        assert int(got.count) > 64
    elif budget != "global_cap":
        assert int(got.count) < 0


def _scene(seed, n=120):
    """A pit with balls scattered through it at random orientations: many
    ball-ball overlaps and ball-ground/wall contacts."""
    rng = np.random.default_rng(seed)
    js = jax_ball_pit(n)
    ts = ball_pit(n, device="cpu")
    tr = np.asarray(js.bodies.poses.translation).copy()
    rot = np.asarray(js.bodies.poses.rotation).copy()
    half = float(np.abs(tr[1:5, 0]).max()) - 0.6
    tr[5:, 0] = rng.uniform(-half, half, n)
    tr[5:, 2] = rng.uniform(-half, half, n)
    tr[5:, 1] = rng.uniform(0.3, 2.5, n)
    q = rng.normal(size=(n, 4))
    rot[5:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    js.bodies.poses.translation = jnp.asarray(tr)
    js.bodies.poses.rotation = jnp.asarray(rot)
    ts.bodies.poses.translation = torch.from_numpy(tr)
    ts.bodies.poses.rotation = torch.from_numpy(rot)
    from wgmath_tpu.shapes.shape import world_aabbs

    mins, maxs = world_aabbs(js.shapes, js.bodies.poses, margin=PRED)
    jp = jax_find_pairs(mins, maxs, capacity=2048, max_per_row=64)
    tp = PairList(*(torch.from_numpy(np.array(x, np.int64))
                    if np.asarray(x).dtype != np.bool_
                    else torch.from_numpy(np.array(x))
                    for x in (jp.body_a, jp.body_b, jp.valid, jp.count)))
    return js, ts, jp, tp


@pytest.mark.parametrize("bc_capacity", [0, 256, 16],
                         ids=["dense", "compacted", "truncated"])
def test_narrow_phase_matches_jax(bc_capacity):
    js, ts, jp, tp = _scene(4)
    want, want_need = jax_narrow(js.bodies.poses, js.shapes, jp, PRED,
                                 p_max=1, bc_capacity=bc_capacity,
                                 with_overflow=True)
    got, got_need = narrow_phase(ts.bodies.poses, ts.shapes, tp, PRED,
                                 p_max=1, bc_capacity=bc_capacity,
                                 with_overflow=True)
    np.testing.assert_array_equal(got_need.numpy(), np.asarray(want_need))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.num_points.numpy(),
                                  np.asarray(want.num_points))
    v = np.asarray(want.valid)
    assert v.sum() > 50
    if bc_capacity == 16:
        assert int(want_need[0]) > 16  # demand reported past the capacity
    # invalid slots keep dist 1e9; geometry to float32 rounding
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.normal_a.numpy(),
                               np.asarray(want.normal_a), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.points_a.numpy(),
                               np.asarray(want.points_a), rtol=1e-5,
                               atol=1e-6)


def test_narrow_phase_refuses_cuboid_manifolds():
    """The narrow phase refuses the shape kinds whose kernels lie outside
    the 3D step (a polyline's: its contacts are 2D, which a 2D step
    takes, ``tests/test_torch_planar.py``; the
    standalone segments, triangles and convex shapes take the
    support-mapped branch, ``tests/test_torch_mesh.py``, and trimeshes the
    mesh contacts the step appends). Cuboid-cuboid pairs at ``p_max`` 4
    get SAT manifolds (``tests/test_torch_sat.py`` holds them against the
    JAX package's) with their compaction demand, and the ball pairs keep
    their one-point manifolds."""
    _, ts, _, tp = _scene(5, n=16)
    polylines = dataclasses.replace(ts.shapes,
                                    kinds=ts.shapes.kinds | {shp.POLYLINE})
    with pytest.raises(NotImplementedError, match="in 3D"):
        narrow_phase(ts.bodies.poses, polylines, tp, PRED, p_max=4)
    wide, need = narrow_phase(ts.bodies.poses, ts.shapes, tp, PRED, p_max=4,
                              sat_capacity=64, with_overflow=True)
    one, _ = narrow_phase(ts.bodies.poses, ts.shapes, tp, PRED, p_max=1,
                          with_overflow=True)
    tag = ts.shapes.tag
    cc = (tag[tp.body_a] == shp.CUBOID) & (tag[tp.body_b] == shp.CUBOID)
    assert int(need[1]) == int((cc & tp.valid).sum()) > 0
    assert torch.equal(wide.dist[~cc, 0], one.dist[~cc, 0])
    assert torch.equal(wide.num_points[~cc], one.num_points[~cc])


def test_pair_list_dataclass_matches_jax_fields():
    assert [f for f in PairList.__dataclass_fields__] == [
        f for f in JaxPairList.__dataclass_fields__]
