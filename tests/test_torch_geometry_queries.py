"""The port's 2D rotations, quaternion and similarity ops (row-major and
component-major), shape constructors, ray casts and point projections
against the JAX package on the same seeded inputs, on the CPU.

Tolerances: rtol 1e-5 and atol 1e-5 on floats (both sides round each f32
op once; XLA's CPU backend may contract a product and a sum into one
rounding), hit masks and inside flags exact. Each test runs its JAX side
as one jitted call per shape, which costs less than op-by-op dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ray_bench_arrays
from wgmath_tpu.core import module as jax_module
from wgmath_tpu.geometry import quat as jquat
from wgmath_tpu.geometry import rot2 as jrot2
from wgmath_tpu.geometry import sim as jsim
from wgmath_tpu.queries import projection as jproj
from wgmath_tpu.queries import ray as jray
from wgmath_tpu.shapes import shape as jshape
from wgmath_tpu.shapes.mesh import convex_polyhedron, heightfield, polyline
from wgmath_tpu_torch.convert import (
    shapes_from_arrays,
    shapes_to_arrays,
    sim_from_arrays,
    sim_to_arrays,
)
from wgmath_tpu_torch.core.module import compile_check, compose, get_module
from wgmath_tpu_torch.dynamics.body import Velocity
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import quat as tquat
from wgmath_tpu_torch.geometry import rot2 as trot2
from wgmath_tpu_torch.geometry import sim as tsim
from wgmath_tpu_torch.queries import projection as tproj
from wgmath_tpu_torch.queries import ray as tray
from wgmath_tpu_torch.scenes import builders as tbuilders
from wgmath_tpu_torch.shapes import shape as tshape
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want, strict=True):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _sims(rng, n, dim):
    rot = (_unit_quats(rng, n) if dim == 3 else
           np.stack([np.cos(a := rng.uniform(-3, 3, n)), np.sin(a)],
                    -1).astype(np.float32))
    parts = (rot, _f32(rng, n, dim), rng.uniform(0.5, 2.0, n)
             .astype(np.float32))
    return (tsim.Sim(*(_t(x) for x in parts)),
            jsim.Sim(*(jnp.asarray(x) for x in parts)))


def _sim_close(got, want):
    _close((got.rotation, got.translation, got.scale),
           (want.rotation, want.translation, want.scale))


# --- rotations and similarities ----------------------------------------------


def test_rot2_ops_match_jax():
    rng = np.random.default_rng(0)
    ang, ang_b = (rng.uniform(-3.0, 3.0, 64).astype(np.float32)
                  for _ in range(2))
    v = _f32(rng, 64, 2)

    def ops(m, ang, ang_b, v):
        a, b = m.from_angle(ang), m.from_angle(ang_b)
        return (a, m.angle(a), m.mul(a, b), m.inv(a), m.normalize(a * 3.0),
                m.mul_vec(a, v), m.inv_mul_vec(a, v), m.to_matrix(a))

    want = jax.jit(lambda *x: ops(jrot2, *x))(*map(jnp.asarray,
                                                   (ang, ang_b, v)))
    _close(ops(trot2, *map(_t, (ang, ang_b, v))), want)
    _same(trot2.identity((3, 2), device="cpu"), jrot2.identity((3, 2)))


@pytest.mark.parametrize("n", [64, 32768])
def test_quat_ops_match_jax(n):
    """At 32,768 the JAX package takes its transposed route for mul,
    normalize and mul_vec; the port computes the same terms row-major."""
    rng = np.random.default_rng(n)
    a, b = _unit_quats(rng, n), _unit_quats(rng, n)
    v = _f32(rng, n, 3)

    def ops(m, a, b, v):
        return (m.mul(a, b), m.normalize(a * 3.0), m.mul_vec(a, v),
                m.inv_mul_vec(a, v), m.inv(a), m.to_scaled_axis(a),
                # every branch of from_matrix: rotations of all angles
                m.from_matrix(m.to_matrix(a)), m.slerp(a, b, 0.3),
                # nearly parallel pairs take the normalized-lerp fallback
                m.slerp(a, a, 0.7))

    want = jax.jit(lambda *x: ops(jquat, *x))(*map(jnp.asarray, (a, b, v)))
    _close(ops(tquat, *map(_t, (a, b, v))), want)
    _same(tquat.identity((2,), device="cpu"), jquat.identity((2,)))


@pytest.mark.parametrize("n", [64, 32768])
def test_quat_soa_ops_match_jax(n):
    rng = np.random.default_rng(n + 1)
    a, b = _unit_quats(rng, n), _unit_quats(rng, n)
    v = _f32(rng, n, 3)

    def ops(m, a, b, v):
        ra, rb, rv = (m.split_soa(x) for x in (a, b, v))
        return (m.merge_soa(rv), m.mul_vec_soa(ra, rv), m.mul_soa(ra, rb),
                m.normalize_soa(tuple(r * 3.0 for r in ra)),
                m._conj_soa(ra), m.merge_soa(m.mul_vec_soa(ra, rv)))

    got = ops(tquat, *map(_t, (a, b, v)))
    want = jax.jit(lambda *x: ops(jquat, *x))(*map(jnp.asarray, (a, b, v)))
    _close(got, want)
    _same(got[0], v)
    # the SoA rotate equals the row-major one
    _close(got[-1], jax.jit(jquat.mul_vec)(jnp.asarray(a), jnp.asarray(v)))


@pytest.mark.parametrize("dim,n", [(3, 64), (3, 32768), (2, 64)])
def test_sim_row_major_ops_match_jax(dim, n):
    """At 32,768 the JAX package takes its transposed 3D route."""
    rng = np.random.default_rng(dim * n)
    (ta, ja), (tb, jb) = _sims(rng, n, dim), _sims(rng, n, dim)
    p = _f32(rng, n, dim)
    assert ta.dim == dim and not ta.cm

    def ops(m, a, b, p, **on):
        twice = m.Sim(a.rotation * 2.0, a.translation, a.scale)
        sims = (m.mul(a, b), m.inv(a), m.inv_mul(a, b),
                m.normalize_rotation(twice), m.identity((4,), dim, **on),
                m.from_parts(a.rotation, a.translation))
        return ([(s.rotation, s.translation, s.scale) for s in sims],
                [getattr(m, name)(a, p) for name in (
                    "mul_pt", "inv_mul_pt", "mul_vec", "inv_mul_vec",
                    "mul_unit_vec", "inv_mul_unit_vec")])

    want = jax.jit(lambda a, b, p: ops(jsim, a, b, p))(ja, jb,
                                                      jnp.asarray(p))
    got = ops(tsim, ta, tb, _t(p), device="cpu")
    for g, w in zip(got[0], want[0], strict=True):
        _close(g, w)
    _close(got[1], want[1])


@pytest.mark.parametrize("n", [64, 32768])
def test_sim_component_major_ops_match_jax(n):
    rng = np.random.default_rng(n + 7)
    (ta, ja), (tb, jb) = _sims(rng, n, 3), _sims(rng, n, 3)
    ca, cb = tsim.to_cm(ta), tsim.to_cm(tb)
    ka, kb = jsim.to_cm(ja), jsim.to_cm(jb)
    assert ca.cm and ca.dim == 3 and tsim.to_cm(ca) is ca

    def cm_close(got, want):
        _close((*got.rotation, *got.translation, got.scale),
               (*want.rotation, *want.translation, want.scale))

    cm_close(tsim.mul(ca, cb), jsim.mul(ka, kb))
    cm_close(tsim.inv(ca), jsim.inv(ka))
    cm_close(tsim.inv_mul(ca, cb), jsim.inv_mul(ka, kb))
    cm_close(tsim.normalize_rotation(tsim.Sim(
        tuple(r * 2.0 for r in ca.rotation), ca.translation, ca.scale,
        cm=True)), jsim.normalize_rotation(jsim.Sim(
            tuple(r * 2.0 for r in ka.rotation), ka.translation, ka.scale,
            cm=True)))
    # the bench's chain step, and back to row-major storage
    step = tsim.normalize_rotation(tsim.mul(ca, tsim.inv(cb)))
    _sim_close(tsim.from_cm(step), jsim.from_cm(
        jsim.normalize_rotation(jsim.mul(ka, jsim.inv(kb)))))
    p = _f32(rng, n, 3)
    rows = tquat.split_soa(_t(p))
    _close(tsim.mul_pt(ca, rows), jsim.mul_pt(ka, jquat.split_soa(
        jnp.asarray(p))))
    # the JAX package rotates vectors of a cm similarity only row-major
    _close(tquat.merge_soa(tsim.mul_vec(ca, rows)),
           jsim.mul_vec(ja, jnp.asarray(p)))
    _close(tquat.merge_soa(tsim.inv_mul_vec(ca, rows)),
           jsim.inv_mul_vec(ja, jnp.asarray(p)))
    with pytest.raises(ValueError, match="both operands cm"):
        tsim.mul(ca, tb)


# --- shapes ------------------------------------------------------------------


def _mixed_jax_shapes(rng, n_each, dim=3, round_tags=True):
    """Cuboids, segments, and in 3D cones, cylinders and triangles, with
    random sizes; balls and capsules too with ``round_tags``."""
    def u(*shape):
        return rng.uniform(0.2, 1.0, shape).astype(np.float32)

    sets = [jshape.ShapeSet.cuboids(u(n_each, dim)),
            jshape.ShapeSet.segments(_f32(rng, n_each, dim),
                                     _f32(rng, n_each, dim))]
    if round_tags:
        sets += [jshape.ShapeSet.balls(u(n_each), dim=dim),
                 jshape.ShapeSet.capsules(u(n_each), u(n_each), dim=dim)]
    if dim == 3:
        sets += [jshape.ShapeSet.cones(u(n_each), u(n_each)),
                 jshape.ShapeSet.cylinders(u(n_each), u(n_each)),
                 jshape.ShapeSet.triangles(_f32(rng, n_each, 3, 3))]
    return jshape.ShapeSet.concat(*sets)


def _port(jax_shapes):
    return shapes_from_arrays(shapes_to_arrays(jax_shapes), device="cpu")


def test_shape_constructors_and_aabbs_match_jax():
    rng = np.random.default_rng(3)
    hh, r = (rng.uniform(0.2, 1.0, 8).astype(np.float32) for _ in range(2))
    for name in ("capsules", "cylinders", "cones"):
        got = getattr(tshape.ShapeSet, name)(_t(hh), _t(r))
        want = getattr(jshape.ShapeSet, name)(hh, r)
        _same(got.tag, want.tag)
        _same(got.params, want.params)
        assert got.kinds == want.kinds
        assert tuple(got.vertices.shape) == want.vertices.shape

    def aabbs(m, shapes, poses, dim):
        return (m.local_aabb_half_extents(shapes, dim),
                *m.world_aabbs(shapes, poses, margin=0.01))

    for dim in (3, 2):
        js = _mixed_jax_shapes(rng, 6, dim)
        ts = _port(js)
        assert ts.kinds == js.kinds and ts.num_shapes == js.num_shapes
        tp, jp = _sims(rng, ts.num_shapes, dim)
        got = aabbs(tshape, ts, tp, dim)
        want = jax.jit(aabbs, static_argnums=(0, 3))(jshape, js, jp, dim)
        _same(got[0], want[0])
        _close(got[1:], want[1:])
    # the port's default kinds are the JAX package's: every tag
    assert tshape.ALL_KINDS == jshape.ShapeSet.__dataclass_fields__[
        "kinds"].default


def test_convert_round_trips():
    rng = np.random.default_rng(4)
    line = polyline(_f32(rng, 40, 2), closed=True)
    js = jshape.ShapeSet.concat(jshape.ShapeSet.balls(
        np.ones(3, np.float32), dim=2), line)
    arrays = shapes_to_arrays(js)
    again = shapes_to_arrays(shapes_from_arrays(arrays, device="cpu"))
    assert arrays.keys() == again.keys()
    for k in arrays:
        np.testing.assert_array_equal(again[k], arrays[k])
    assert arrays["cluster_min"].shape[0] > 0
    _, js3 = _sims(rng, 16, 3)
    for sim in (js3, jsim.to_cm(js3)):
        arrays = sim_to_arrays(sim)
        ts = sim_from_arrays(arrays, device="cpu")
        assert ts.cm == sim.cm
        again = sim_to_arrays(ts)
        for k in arrays:
            np.testing.assert_array_equal(again[k], arrays[k])


# --- ray casts ---------------------------------------------------------------

_jax_cast = jax.jit(jray.cast)


def _rays(rng, n, dim=3, spread=3.0):
    """Origins inside and around a unit-sized shape at the origin, unit
    directions, half of them aimed near the origin."""
    o = _f32(rng, n, dim, scale=spread)
    d = _f32(rng, n, dim)
    d[::2] = -o[::2] + _f32(rng, (n + 1) // 2, dim, scale=0.3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _cast_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    hit = np.isfinite(want)
    np.testing.assert_allclose(got[hit], want[hit], rtol=RTOL, atol=ATOL)
    return int(hit.sum())


def test_analytic_ray_casts_match_jax():
    rng = np.random.default_rng(5)
    n = 512
    o, d = _rays(rng, n)
    # grazing rays: tangent to the unit sphere, along a cuboid face, along
    # the cylinder's side; and an origin inside every shape
    o[:4] = [[-3.0, 1.0, 0.0], [-3.0, 0.5, 0.5], [-3.0, 0.0, 0.7],
             [0.1, 0.1, 0.1]]
    d[:4] = [[1.0, 0.0, 0.0]] * 4
    he = np.asarray([0.5, 0.5, 0.5], np.float32)
    radii = rng.uniform(0.5, 1.0, n).astype(np.float32)
    tri = _f32(rng, 3, 3)
    o2, d2 = _rays(rng, n, dim=2)
    seg = _f32(rng, 2, 2)

    def casts(m, o, d, radii, he, tri, o2, d2, seg):
        return (m.ray_ball(o, d, 1.0), m.ray_ball(o, d, radii),
                m.ray_cuboid(o, d, he), m.ray_capsule(o, d, 0.7, 0.7),
                m.ray_cylinder(o, d, 0.7, 0.7), m.ray_cone(o, d, 0.7, 0.7),
                m.ray_triangle(o, d, tri[0], tri[1], tri[2]),
                m.ray_segment_2d(o2, d2, seg[0], seg[1]))

    args = (o, d, radii, he, tri, o2, d2, seg)
    got = casts(tray, *map(_t, args))
    want = jax.jit(lambda *x: casts(jray, *x))(*map(jnp.asarray, args))
    hits = [_cast_close(g, w) for g, w in zip(got, want, strict=True)]
    assert min(hits) > 20  # every shape is hit by some rays, missed by some
    assert max(hits) < n


def test_cast_bench_mixed_set_matches_jax():
    """A 4,096-ray copy of the bench's raycast section: its mixed ball /
    cuboid / capsule set with the default kinds (so the dense mesh branch
    runs on an empty index buffer) and its poses and directions."""
    z = ray_bench_arrays(4096, 3)
    js = jshape.ShapeSet(jnp.asarray(z["tag"]), jnp.asarray(z["params"]),
                         jnp.zeros((0, 3), jnp.float32),
                         jnp.zeros((0, 3), jnp.int32))
    ts = tshape.ShapeSet(_t(z["tag"]).long(), _t(z["params"]),
                         torch.zeros((0, 3)),
                         torch.zeros((0, 3), dtype=torch.int64))
    keys = ("rotation", "translation", "scale")
    jp = jsim.Sim(*(jnp.asarray(z[k]) for k in keys))
    tp = tsim.Sim(*(_t(z[k]) for k in keys))
    rays = (z["origins"], z["dirs"])
    for max_toi in (float("inf"), 1e5):  # max_toi clamps on both sides alike
        got = tray.cast(ts, tp, *map(_t, rays), max_toi)
        want = _jax_cast(js, jp, *map(jnp.asarray, rays), max_toi)
        assert _cast_close(got, want) > 0


def _tiled(row_set, n, others):
    """``others`` followed by ``n`` copies of the single-collider mesh set
    ``row_set``, sharing its buffers (one ray per copy)."""
    tags = np.concatenate([np.asarray(others.tag),
                           np.repeat(np.asarray(row_set.tag), n)])
    params = np.concatenate([np.asarray(others.params),
                             np.repeat(np.asarray(row_set.params), n, 0)])
    return jshape.ShapeSet(
        jnp.asarray(tags), jnp.asarray(params), row_set.vertices,
        row_set.indices, row_set.cluster_min, row_set.cluster_max,
        kinds=others.kinds | row_set.kinds)


def test_2d_casts_and_dense_polyline_match_jax():
    rng = np.random.default_rng(6)
    n_each = 64
    others = jshape.ShapeSet.concat(
        jshape.ShapeSet.balls(rng.uniform(0.3, 1.0, n_each)
                              .astype(np.float32), dim=2),
        jshape.ShapeSet.cuboids(rng.uniform(0.3, 1.0, (n_each, 2))
                                .astype(np.float32)))
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    js = _tiled(polyline(ring, closed=True), n_each, others)
    n = 3 * n_each
    tp, jp = _sims(rng, n, 2)
    o, d = _rays(rng, n, dim=2)
    o = o + np.asarray(jp.translation)  # aim near each collider
    got = tray.cast(_port(js), tp, _t(o), _t(d))
    want = _jax_cast(js, jp, jnp.asarray(o), jnp.asarray(d))
    assert _cast_close(got[2 * n_each:], want[2 * n_each:]) > 10
    _cast_close(got, want)


def test_dense_trimesh_cast_matches_jax():
    rng = np.random.default_rng(7)
    hf = heightfield(_f32(rng, 6, 6, scale=0.1), 1.0, 1.0)
    n = 32
    js = _tiled(hf, n, jshape.ShapeSet.balls(np.ones(0, np.float32)))
    tp, jp = _sims(rng, n, 3)
    # rays straight down each collider's local Y
    o = (np.asarray(jsim.mul_pt(jp, jnp.asarray(np.tile(
        [[0.0, 3.0, 0.0]], (n, 1)).astype(np.float32))))
        + _f32(rng, n, 3, scale=0.3)).astype(np.float32)
    d = np.asarray(jquat.mul_vec(jp.rotation, jnp.asarray(np.tile(
        [[0.0, -1.0, 0.0]], (n, 1)).astype(np.float32))))
    got = tray.cast(_port(js), tp, _t(o), _t(d))
    want = _jax_cast(js, jp, jnp.asarray(o), jnp.asarray(d))
    assert _cast_close(got, want) > n // 2


def test_ray_refusals_and_empty_meshes():
    rng = np.random.default_rng(8)
    o, d = _rays(rng, 8)
    ts = tshape.ShapeSet.balls(torch.ones(8))
    # no index rows: +inf, as the JAX package returns
    t = tray.ray_trimesh(_t(o), _t(d), ts, torch.zeros(8, dtype=torch.long),
                         torch.zeros(8, dtype=torch.long))
    assert bool(torch.isinf(t).all())
    # a mesh that takes the clustered route (once refused): its triangles
    # are all degenerate, so every ray misses
    big = tshape.ShapeSet(torch.full((8,), tshape.TRIMESH), torch.zeros(8, 8),
                          torch.zeros(3, 3),
                          torch.zeros((tray.ACCEL_MIN_PRIMS, 3),
                                      dtype=torch.int64),
                          torch.zeros(64, 3), torch.zeros(64, 3))
    t = tray.cast(big, tsim.identity((8,), device="cpu"), _t(o), _t(d))
    assert bool(torch.isinf(t).all())


# --- projections -------------------------------------------------------------


def _proj_close(got, want):
    _close(got.point, want.point)
    _same(got.is_inside, want.is_inside)


@pytest.mark.parametrize("boundary", [False, True])
def test_local_projections_match_jax(boundary):
    rng = np.random.default_rng(9 + boundary)
    p = _f32(rng, 512, 3, scale=0.8)
    he = rng.uniform(0.2, 1.0, (512, 3)).astype(np.float32)
    a, b, c = (_f32(rng, 512, 3) for _ in range(3))

    def projs(m, p, he, a, b, c):
        kw = dict(boundary=boundary)
        out = (m.project_ball(p, 0.7, **kw), m.project_cuboid(p, he, **kw),
               m.project_cuboid(p, he[0], **kw),
               m.project_capsule(p, 0.6, 0.5, **kw),
               m.project_cone(p, 0.6, 0.5, **kw),
               m.project_cylinder(p, 0.6, 0.5, **kw),
               m.project_segment(p, a, b), m.project_triangle(p, a, b, c))
        return [(r.point, r.is_inside) for r in out]

    args = (p, he, a, b, c)
    got = projs(tproj, *map(_t, args))
    want = jax.jit(lambda *x: projs(jproj, *x))(*map(jnp.asarray, args))
    for (gp, gi), (wp, wi) in zip(got, want, strict=True):
        _close(gp, wp)
        _same(gi, wi)
    assert 0 < int(got[5][1].sum()) < 512  # the cylinder: inside and out


@pytest.mark.parametrize("boundary", [False, True])
def test_project_world_dispatch_matches_jax(boundary):
    """Every tag through ``project`` on posed colliders. The JAX package's
    ``project`` cannot broadcast a per-shape ball or 3D capsule radius, so
    there the balls (radius 0.7) and capsules (0.6, 0.5) are held against
    its local functions and ``mul_pt``; the other tags against its
    ``project``."""
    rng = np.random.default_rng(11 + boundary)
    n = 48
    js = jshape.ShapeSet.concat(
        _mixed_jax_shapes(rng, n, round_tags=False),
        jshape.ShapeSet.balls(np.full(n, 0.7, np.float32)),
        jshape.ShapeSet.capsules(np.full(n, 0.6, np.float32),
                                 np.full(n, 0.5, np.float32)))
    m = js.num_shapes - 2 * n
    tp, jp = _sims(rng, js.num_shapes, 3)
    pts = np.asarray(jp.translation) + _f32(rng, js.num_shapes, 3)
    got = tproj.project(_port(js), tp, _t(pts), boundary=boundary)

    part = jshape.ShapeSet(js.tag[:m], js.params[:m], js.vertices,
                           js.indices,
                           kinds=js.kinds - {jshape.BALL, jshape.CAPSULE})

    def jax_side(part, jp, pts):
        res = jproj.project(part, jax.tree.map(lambda x: x[:m], jp),
                            pts[:m], boundary=boundary)
        p_loc = jsim.inv_mul_pt(jp, pts)
        balls = jproj.project_ball(p_loc[m:m + n], 0.7, boundary=boundary)
        caps = jproj.project_capsule(p_loc[m + n:], 0.6, 0.5,
                                     boundary=boundary)
        local = jnp.concatenate([balls.point, caps.point])
        return (jnp.concatenate([res.point, jsim.mul_pt(
                    jax.tree.map(lambda x: x[m:], jp), local)]),
                jnp.concatenate([res.is_inside, balls.is_inside,
                                 caps.is_inside]))

    want = jax.jit(jax_side)(part, jp, jnp.asarray(pts))
    _close(got.point, want[0])
    _same(got.is_inside, want[1])
    # 2D: cuboids, capsules along local Y, segments
    js2 = jshape.ShapeSet.concat(
        jshape.ShapeSet.cuboids(rng.uniform(0.2, 1, (n, 2))
                                .astype(np.float32)),
        jshape.ShapeSet.capsules(*(rng.uniform(0.2, 1, n).astype(np.float32)
                                   for _ in range(2)), dim=2),
        jshape.ShapeSet.segments(_f32(rng, n, 2), _f32(rng, n, 2)))
    tp2, jp2 = _sims(rng, 3 * n, 2)
    pts2 = np.asarray(jp2.translation) + _f32(rng, 3 * n, 2)
    want2 = jax.jit(jproj.project, static_argnames=("boundary",))(
        js2, jp2, jnp.asarray(pts2), boundary=boundary)
    _proj_close(tproj.project(_port(js2), tp2, _t(pts2), boundary=boundary),
                want2)


def test_project_refusals():
    n = 4
    params = np.zeros((n, 8), np.float32)
    params[:, 0] = 1.0
    cone2d = dict(tag=np.full(n, jshape.CONE, np.int32), params=params,
                  vertices=np.zeros((0, 2), np.float32),
                  indices=np.zeros((0, 2), np.int32),
                  cluster_min=np.zeros((0, 2), np.float32),
                  cluster_max=np.zeros((0, 2), np.float32),
                  kinds=np.asarray([jshape.CONE], np.int32))
    rot = np.tile(np.asarray([[0.0, 1.0]], np.float32), (n, 1))
    jp = jsim.Sim(jnp.asarray(rot), jnp.zeros((n, 2)), jnp.ones((n,)))
    tp = tsim.Sim(_t(rot), torch.zeros((n, 2)), torch.ones(n))
    with pytest.raises(ValueError) as ours:
        tproj.project(shapes_from_arrays(cone2d, device="cpu"), tp,
                      torch.zeros((n, 2)))
    with pytest.raises(ValueError) as theirs:
        jproj.project(jshape.ShapeSet(
            *(jnp.asarray(cone2d[k]) for k in ("tag", "params", "vertices",
                                               "indices")),
            kinds=frozenset((jshape.CONE,))), jp, jnp.zeros((n, 2)))
    assert str(ours.value) == str(theirs.value)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32)
    hf = heightfield(np.zeros((3, 3), np.float32), 1.0, 1.0)
    # once refused, now projected: a convex polyhedron (GJK outside) and a
    # heightfield (its nearest triangle; tests/test_torch_mesh.py holds
    # both against the JAX package)
    for js, pt, want in ((convex_polyhedron(corners), [0.0, 3.0, 0.0],
                          [0.0, 1.0, 0.0]),
                         (hf, [0.2, 0.5, -0.3], [0.2, 0.0, -0.3])):
        got = tproj.project(_port(js), tsim.identity((1,), device="cpu"),
                            torch.tensor([pt]))
        np.testing.assert_allclose(got.point.numpy(), [want], atol=1e-4)
        assert not bool(got.is_inside.any())


@pytest.mark.parametrize("make", [
    lambda **kw: tquat.identity((2,), **kw),
    lambda **kw: trot2.identity((2,), **kw),
    lambda **kw: tsim.identity((2,), **kw).translation,
    lambda **kw: Velocity.zero(2, **kw).linear,
    lambda **kw: SimParams().gravity_array(3, **kw),
    lambda **kw: tbuilders.boxes(8, **kw).bodies.poses.translation,
    lambda **kw: tbuilders.pyramid(2, **kw).bodies.poses.translation,
    lambda **kw: tbuilders.keva_tower(2, 2, **kw).bodies.poses.rotation,
    lambda **kw: tbuilders.many_pyramids(2, 2, **kw).shapes.params,
    lambda **kw: tbuilders.boxes_and_balls(6, **kw).shapes.tag,
    lambda **kw: tbuilders.SCENES["keva3"](**kw).bodies.vels.linear,
    lambda **kw: tbuilders.primitives3(2, **kw).bodies.poses.translation,
], ids=["quat.identity", "rot2.identity", "sim.identity", "Velocity.zero",
        "SimParams.gravity_array", "builders.boxes", "builders.pyramid",
        "builders.keva_tower", "builders.many_pyramids",
        "builders.boxes_and_balls", "builders.SCENES",
        "builders.primitives3"])
def test_constructors_default_to_the_card(make):
    """With no device given a constructor builds on the card, as every
    entry point of the port does; without CUDA it raises and names the
    CPU way out."""
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make()


# --- registry ----------------------------------------------------------------


@pytest.mark.parametrize("mod", ["geometry.rot2", "geometry.quat",
                                 "geometry.sim", "queries.ray",
                                 "queries.projection"])
def test_query_modules_match_the_jax_registry(mod):
    ours, theirs = get_module(mod), jax_module.get_module(mod)
    assert list(ours.entries) == list(theirs.entries)
    assert list(ours.provides) == list(theirs.provides)
    assert ours.deps == theirs.deps
    assert list(compose(mod)) == list(jax_module.compose(mod))
    assert compile_check(mod, device="cpu") == list(ours.entries)
