"""Shape tagged union as structure of arrays (counterpart of
``wgmath_tpu/shapes/shape.py``): one i64 tag per body plus an f32 param
row, and the shared vertex / index buffers that mesh-backed shapes point
into. ``kinds`` is the static set of tags present; it gates the
narrow-phase kernels and the per-tag branches of the queries.

Param layout per tag (params[:, 0:8]):
- BALL:     [radius]
- CUBOID:   [hx, hy(, hz)]
- CAPSULE:  [half_height, radius]           (segment along local Y)
- CONE:     [half_height, radius]           (3D; apex +Y)
- CYLINDER: [half_height, radius]           (3D)
- SEGMENT:  [ax, ay, az, bx, by, bz]
- TRIANGLE: vertex buffer ref [first_vtx, 3]
- POLYLINE / TRIMESH / CONVEX: [first_vtx, num_vtx, first_idx, num_idx]
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.geometry import quat, rot2
from wgmath_tpu_torch.geometry.sim import Sim

BALL = 0
CUBOID = 1
CAPSULE = 2
CONE = 3
CYLINDER = 4
SEGMENT = 5
TRIANGLE = 6
POLYLINE = 7
TRIMESH = 8
CONVEX = 9

NUM_PARAMS = 8
ALL_KINDS = frozenset(range(10))
# the tags the 3D physics step takes: analytic ball and cuboid contacts,
# the support-mapped (GJK / EPA / PFM) contacts of the primitives, the
# standalone segments and triangles and the convex polyhedra, and the mesh
# contacts of triangle meshes
SUPPORTED_KINDS = frozenset((BALL, CUBOID, CAPSULE, CONE, CYLINDER, SEGMENT,
                             TRIANGLE, TRIMESH, CONVEX))
# the tags the 2D step takes: analytic ball and cuboid contacts, the
# support-mapped capsule contacts and the polyline contacts
PLANAR_KINDS = frozenset((BALL, CUBOID, CAPSULE, POLYLINE))
# the vertex-range kinds: the GJK support's arg-max runs over their vertices
VERTEX_RANGE_KINDS = frozenset((TRIANGLE, CONVEX))


@dataclasses.dataclass
class ShapeSet:
    tag: torch.Tensor  # i64 [N]
    params: torch.Tensor  # f32 [N, NUM_PARAMS]
    vertices: torch.Tensor  # f32 [V, dim]
    indices: torch.Tensor  # i64 [I, dim] (triangles in 3D, segments in 2D)
    # the mesh clusters of the JAX package's two-level acceleration: one
    # AABB per run of primitives; empty unless a mesh built them
    cluster_min: torch.Tensor | None = None  # f32 [C, dim]
    cluster_max: torch.Tensor | None = None  # f32 [C, dim]
    kinds: frozenset = ALL_KINDS
    # the widest vertex range of a TRIANGLE or CONVEX row (a host value,
    # read once: see vertex_window)
    _window: int | None = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)

    def __post_init__(self):
        if self.cluster_min is None:
            empty = torch.zeros((0, self.vertices.shape[1]),
                                device=self.vertices.device)
            self.cluster_min, self.cluster_max = empty, empty.clone()

    @property
    def num_shapes(self) -> int:
        return self.tag.shape[0]

    @staticmethod
    def _of(tag: int, params: torch.Tensor, dim: int) -> "ShapeSet":
        n, dev = params.shape[0], params.device
        return ShapeSet(torch.full((n,), tag, dtype=torch.int64, device=dev),
                        params, torch.zeros((0, dim), device=dev),
                        torch.zeros((0, dim), dtype=torch.int64, device=dev),
                        kinds=frozenset((tag,)))

    @staticmethod
    def _leading(*cols: torch.Tensor) -> torch.Tensor:
        """A param matrix whose first columns are ``cols``, the rest 0."""
        params = torch.zeros((cols[0].shape[0], NUM_PARAMS),
                             dtype=torch.float32, device=cols[0].device)
        for i, c in enumerate(cols):
            params[:, i] = c.to(torch.float32)
        return params

    @staticmethod
    def balls(radii: torch.Tensor, dim: int = 3) -> "ShapeSet":
        return ShapeSet._of(BALL, ShapeSet._leading(radii), dim)

    @staticmethod
    def cuboids(half_extents: torch.Tensor) -> "ShapeSet":
        he = half_extents.to(torch.float32)
        n, dim = he.shape
        params = torch.zeros((n, NUM_PARAMS), dtype=torch.float32,
                             device=he.device)
        params[:, :dim] = he
        return ShapeSet._of(CUBOID, params, dim)

    @staticmethod
    def capsules(half_heights: torch.Tensor, radii: torch.Tensor,
                 dim: int = 3) -> "ShapeSet":
        """Capsules along local Y."""
        return ShapeSet._of(CAPSULE, ShapeSet._leading(half_heights, radii),
                            dim)

    @staticmethod
    def cylinders(half_heights: torch.Tensor,
                  radii: torch.Tensor) -> "ShapeSet":
        """3D cylinders, axis +Y."""
        return ShapeSet._of(CYLINDER,
                            ShapeSet._leading(half_heights, radii), 3)

    @staticmethod
    def cones(half_heights: torch.Tensor, radii: torch.Tensor) -> "ShapeSet":
        """3D cones, apex +Y, base disk at −half_height."""
        return ShapeSet._of(CONE, ShapeSet._leading(half_heights, radii), 3)

    @staticmethod
    def segments(a: torch.Tensor, b: torch.Tensor) -> "ShapeSet":
        """Standalone segment colliders from ``a`` to ``b`` [N, dim]
        (shape-local); params [a | b], the GJK support's core."""
        a, b = a.to(torch.float32), b.to(torch.float32)
        n, dim = a.shape
        params = torch.zeros((n, NUM_PARAMS), dtype=torch.float32,
                             device=a.device)
        params[:, :dim] = a
        params[:, dim:2 * dim] = b
        return ShapeSet._of(SEGMENT, params, dim)

    @staticmethod
    def triangles(verts: torch.Tensor) -> "ShapeSet":
        """Standalone triangle colliders, ``verts`` [N, 3, 3] shape-local,
        stored as vertex-buffer ranges (params [first_vtx, 3]) like CONVEX,
        with the symmetric per-axis max |vertex| in params[4:7]."""
        verts = verts.to(torch.float32)
        n, dev = verts.shape[0], verts.device
        params = torch.zeros((n, NUM_PARAMS), dtype=torch.float32,
                             device=dev)
        params[:, 0] = torch.arange(n, dtype=torch.float32, device=dev) * 3
        params[:, 1] = 3.0
        params[:, 4:7] = torch.amax(torch.abs(verts), dim=1)
        out = ShapeSet._of(TRIANGLE, params, 3)
        out.vertices = verts.reshape(n * 3, 3)
        return out

    @staticmethod
    def concat(*sets: "ShapeSet") -> "ShapeSet":
        """Concatenate shape sets, rebasing mesh buffer references. With a
        clustered mesh among them every set must hold one cluster a
        ``MESH_LEAF`` index rows (mesh constructors do), so that cluster id
        = primitive id // ``MESH_LEAF`` holds across the concatenation."""
        from wgmath_tpu_torch.queries.mesh_accel import MESH_LEAF

        if any(s.cluster_min.shape[0] for s in sets):
            for s in sets:
                if s.cluster_min.shape[0] * MESH_LEAF != s.indices.shape[0]:
                    raise ValueError(
                        "cluster-accelerated concat needs one cluster per "
                        f"MESH_LEAF index rows: {s.cluster_min.shape[0]} "
                        f"clusters vs {s.indices.shape[0]} index rows")
        params, idxs = [], []
        v_off = i_off = 0
        for s in sets:
            p = s.params.clone()
            is_mesh = (s.tag >= POLYLINE) | (s.tag == TRIANGLE)
            p[:, 0] = torch.where(is_mesh, p[:, 0] + v_off, p[:, 0])
            p[:, 2] = torch.where(s.tag >= POLYLINE, p[:, 2] + i_off, p[:, 2])
            params.append(p)
            idxs.append(s.indices + v_off)
            v_off += s.vertices.shape[0]
            i_off += s.indices.shape[0]
        return ShapeSet(torch.cat([s.tag for s in sets]), torch.cat(params),
                        torch.cat([s.vertices for s in sets]),
                        torch.cat(idxs),
                        torch.cat([s.cluster_min for s in sets]),
                        torch.cat([s.cluster_max for s in sets]),
                        kinds=frozenset().union(*(s.kinds for s in sets)))


def vertex_window(shapes: ShapeSet) -> int:
    """The widest vertex range among the TRIANGLE and CONVEX rows (0
    without such a kind): the GJK support's arg-max then gathers that many
    vertices a row (``gjk.support_core``'s ``window``) in place of a dot
    with the whole shared buffer, which a trimesh fills. One host read the
    first time, kept on the set."""
    if shapes._window is None:
        if shapes.kinds & VERTEX_RANGE_KINDS and shapes.vertices.shape[0]:
            rng = ((shapes.tag == TRIANGLE) | (shapes.tag == CONVEX))
            num = torch.where(rng, shapes.params[:, 1],
                              torch.zeros_like(shapes.params[:, 1]))
            shapes._window = int(num.max().item()) if num.numel() else 0
        else:
            shapes._window = 0
    return shapes._window


def local_aabb_half_extents(shapes: ShapeSet, dim: int) -> torch.Tensor:
    """Symmetric local AABB half extents [N, dim]: exact for ball/cuboid,
    the height+radius box for capsule, cone and cylinder, the per-axis
    largest |endpoint| for a segment, and the bound stored in
    params[4:4+dim] for mesh-backed shapes. Only the tags in
    ``shapes.kinds`` are evaluated."""
    p = shapes.params
    tag = shapes.tag[:, None]
    kinds = shapes.kinds
    hh, rad = p[:, 0:1], p[:, 1:2]
    mid = [rad] if dim == 3 else []
    he = p[:, 4:4 + dim]  # mesh-backed shapes
    if SEGMENT in kinds:
        he = torch.where(tag == SEGMENT, torch.maximum(
            torch.abs(p[:, :dim]), torch.abs(p[:, dim:2 * dim])), he)
    if kinds & {CONE, CYLINDER}:
        he = torch.where((tag == CONE) | (tag == CYLINDER),
                         torch.cat([rad, hh] + mid, dim=1), he)
    if CAPSULE in kinds:
        he = torch.where(tag == CAPSULE, torch.cat([rad, hh + rad] + mid,
                                                   dim=1), he)
    if CUBOID in kinds:
        he = torch.where(tag == CUBOID, p[:, :dim], he)
    if BALL in kinds:
        he = torch.where(tag == BALL, p[:, 0:1].expand(-1, dim), he)
    return he


def world_aabbs(shapes: ShapeSet, poses: Sim, *, margin: float = 0.0):
    """(mins, maxs) world AABBs [N, dim]: |R|·he, he itself for balls."""
    dim = poses.translation.shape[-1]
    he = local_aabb_half_extents(shapes, dim) * poses.scale[:, None]
    rot = quat if dim == 3 else rot2
    rmat = torch.abs(rot.to_matrix(poses.rotation))
    world_he = torch.sum(rmat * he[:, None, :], dim=-1)
    world_he = torch.where((shapes.tag == BALL)[:, None], he,
                           world_he) + margin
    center = poses.translation
    return center - world_he, center + world_he


def ball_radii_or_nan(shapes: ShapeSet, poses: Sim) -> torch.Tensor:
    """[N] scale-adjusted ball radius, NaN for non-ball shapes."""
    r = shapes.params[:, 0] * poses.scale
    return torch.where(shapes.tag == BALL, r,
                       torch.full_like(r, float("nan")))


def vertex_collider_ids(shapes: ShapeSet) -> torch.Tensor:
    """[V] the shape owning each row of the shared vertex buffer, -1 for
    rows no mesh-backed shape references (the reference's per-vertex
    collider map). Mesh-backed shapes own disjoint (first_vtx, num_vtx)
    runs, so a sort of the run starts and a search resolve each row."""
    n_v = shapes.vertices.shape[0]
    dev = shapes.vertices.device
    tag = shapes.tag
    is_mesh = ((tag == TRIANGLE) | (tag == POLYLINE) | (tag == TRIMESH)
               | (tag == CONVEX))
    first = torch.where(is_mesh, shapes.params[:, 0].to(torch.int64),
                        torch.full_like(tag, n_v + 1))
    num = torch.where(tag == TRIANGLE, torch.full_like(tag, 3),
                      shapes.params[:, 1].to(torch.int64))
    order = torch.argsort(first, stable=True)
    v = torch.arange(n_v, device=dev)
    j = torch.searchsorted(first[order], v, right=True) - 1
    ids = order[torch.clamp(j, 0, tag.shape[0] - 1)]
    ok = is_mesh[ids] & (v >= first[ids]) & (v < first[ids] + num[ids])
    return torch.where(ok, ids, torch.full_like(ids, -1))


def world_vertex_buffer(shapes: ShapeSet, poses: Sim,
                        collider_ids: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """[V, dim] the shared vertex buffer moved into world space by each
    row's owning collider pose; unowned rows pass through."""
    from wgmath_tpu_torch.geometry import sim as sim_ops

    ids = (vertex_collider_ids(shapes) if collider_ids is None
           else collider_ids)
    w = sim_ops.mul_pt(poses.take(torch.clamp(ids, min=0)), shapes.vertices)
    return torch.where((ids >= 0)[:, None], w, shapes.vertices)
