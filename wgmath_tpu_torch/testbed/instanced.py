"""Instanced 3D shape rendering for the testbed viewer (counterpart of
``wgmath_tpu/testbed/instanced.py``): every collider drawn as a real
oriented mesh, one template mesh per shape kind.

Pure numpy and matplotlib ``Poly3DCollection``: per shape kind a low-poly
template mesh is built once; per body the template is scaled by the shape
parameters, rotated by the body's quaternion and translated, all on the
host (rendering reads the state's tensors once a frame). All faces draw as
one collection a frame; the detail drops with the body count so big piles
stay interactive. Mesh-backed shapes (TRIMESH / CONVEX / TRIANGLE /
POLYLINE) render their stored vertex and index buffers instead of a
template. matplotlib is imported inside :func:`render_instanced` only.
"""

from __future__ import annotations

import numpy as np

from wgmath_tpu_torch.shapes.shape import (
    BALL,
    CAPSULE,
    CONE,
    CONVEX,
    CUBOID,
    CYLINDER,
    POLYLINE,
    SEGMENT,
    TRIANGLE,
    TRIMESH,
)

# ---------------------------------------------------------------------------
# template meshes (unit size, +Y axis convention like the shape kernels)
# ---------------------------------------------------------------------------


def _uv_sphere(n_lat: int, n_lon: int) -> tuple[np.ndarray, np.ndarray]:
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts = [np.array([0.0, 1.0, 0.0])]
    for la in lat[1:-1]:
        for lo in lon:
            verts.append(np.array([np.sin(la) * np.cos(lo), np.cos(la),
                                   np.sin(la) * np.sin(lo)]))
    verts.append(np.array([0.0, -1.0, 0.0]))
    v = np.asarray(verts, np.float32)
    faces = []
    ring = lambda i: 1 + i * n_lon
    for j in range(n_lon):
        faces.append([0, ring(0) + j, ring(0) + (j + 1) % n_lon])
    for i in range(n_lat - 3):
        for j in range(n_lon):
            a, b = ring(i) + j, ring(i) + (j + 1) % n_lon
            c, d = ring(i + 1) + j, ring(i + 1) + (j + 1) % n_lon
            faces.append([a, c, d])
            faces.append([a, d, b])
    last = len(v) - 1
    for j in range(n_lon):
        faces.append([last, ring(n_lat - 3) + (j + 1) % n_lon,
                      ring(n_lat - 3) + j])
    return v, np.asarray(faces, np.int32)


def _box() -> tuple[np.ndarray, np.ndarray]:
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return v, np.asarray(faces, np.int32)


def _lathe(profile: list[tuple[float, float]], n_lon: int,
           close_top: bool, close_bot: bool):
    """Surface of revolution about +Y; profile = [(radius, y), ...]."""
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts, rings = [], []
    for r, y in profile:
        if r == 0.0:
            rings.append([len(verts)])
            verts.append(np.array([0.0, y, 0.0]))
        else:
            ring = []
            for lo in lon:
                ring.append(len(verts))
                verts.append(np.array([r * np.cos(lo), y, r * np.sin(lo)]))
            rings.append(ring)
    faces = []
    for r0, r1 in zip(rings[:-1], rings[1:]):
        if len(r0) == 1:
            for j in range(n_lon):
                faces.append([r0[0], r1[(j + 1) % n_lon], r1[j]])
        elif len(r1) == 1:
            for j in range(n_lon):
                faces.append([r0[j], r0[(j + 1) % n_lon], r1[0]])
        else:
            for j in range(n_lon):
                a, b = r0[j], r0[(j + 1) % n_lon]
                c, d = r1[j], r1[(j + 1) % n_lon]
                faces += [[a, b, d], [a, d, c]]
    if close_top and len(rings[0]) > 1:
        c = len(verts)
        verts.append(np.array([0.0, profile[0][1], 0.0]))
        for j in range(n_lon):
            faces.append([c, rings[0][j], rings[0][(j + 1) % n_lon]])
    if close_bot and len(rings[-1]) > 1:
        c = len(verts)
        verts.append(np.array([0.0, profile[-1][1], 0.0]))
        for j in range(n_lon):
            faces.append([c, rings[-1][(j + 1) % n_lon], rings[-1][j]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _templates(detail: int):
    """(verts, faces) templates per shape kind at the given detail level."""
    n = max(6, detail)
    sphere = _uv_sphere(max(4, detail // 2), n)
    cyl = _lathe([(1.0, 1.0), (1.0, -1.0)], n, True, True)
    cone = _lathe([(0.0, 1.0), (1.0, -1.0)], n, False, True)
    # capsule template: unit-radius hemispheres at y=±1 over a unit cylinder
    lat = np.linspace(0, np.pi / 2, max(2, detail // 4) + 1)
    top = [(np.sin(la), 1.0 + np.cos(la)) for la in lat]
    bot = [(np.cos(la), -1.0 - np.sin(la)) for la in np.flip(lat)]
    cap = _lathe(top + bot, n, False, False)
    return {BALL: sphere, CUBOID: _box(), CYLINDER: cyl, CONE: cone,
            CAPSULE: cap}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _quat_rot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate [M,3] verts by one xyzw quaternion (host-side numpy)."""
    u, w = q[:3], q[3]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


class InstancedScene:
    """Precomputed local meshes per body; per-frame pose transform + draw."""

    def __init__(self, state, *, max_faces: int = 20000):
        tags = _host(state.shapes.tag)
        params = _host(state.shapes.params)
        verts_buf = _host(state.shapes.vertices)
        idx_buf = _host(state.shapes.indices)
        n = len(tags)
        # pick template detail so total faces stay bounded
        detail = 12 if n <= 200 else (8 if n <= 2000 else 5)
        tpl = _templates(detail)
        self.local: list[tuple[np.ndarray, np.ndarray]] = []
        self.lines: list[int] = []  # bodies drawn as segments
        for i in range(n):
            t = int(tags[i])
            p = params[i]
            if t == BALL:
                v, f = tpl[BALL]
                self.local.append((v * p[0], f))
            elif t == CUBOID:
                v, f = tpl[CUBOID]
                self.local.append((v * p[:3][None, :], f))
            elif t == CYLINDER:
                v, f = tpl[CYLINDER]
                self.local.append((v * np.array([p[1], p[0], p[1]]), f))
            elif t == CONE:
                v, f = tpl[CONE]
                self.local.append((v * np.array([p[1], p[0], p[1]]), f))
            elif t == CAPSULE:
                v, f = tpl[CAPSULE]
                vv = v.copy()
                # template y in [-2, 2]: cylinder part ±1 scaled by hh,
                # hemisphere offsets scaled by radius
                cyl_y = np.clip(vv[:, 1], -1.0, 1.0)
                cap_y = vv[:, 1] - cyl_y
                vv[:, 1] = cyl_y * p[0] + cap_y * p[1]
                vv[:, 0] *= p[1]
                vv[:, 2] *= p[1]
                self.local.append((vv, f))
            elif t in (TRIMESH, CONVEX):
                # params [first_vtx, n_vtx, first_idx, n_tris]; index rows
                # hold GLOBAL vertex ids (ShapeSet.concat rebases them)
                fi, nt = int(p[2]), int(p[3])
                tri = idx_buf[fi:fi + nt].astype(np.int64)
                vv = verts_buf[tri.reshape(-1)].reshape(-1, 3)
                f = np.arange(len(vv)).reshape(-1, 3)
                self.local.append((vv.astype(np.float32), f))
            elif t == TRIANGLE:
                first = int(p[0])
                vv = verts_buf[first:first + 3]
                self.local.append((vv.astype(np.float32),
                                   np.array([[0, 1, 2]])))
            else:  # SEGMENT / POLYLINE / 2D leftovers: draw as line/points
                self.local.append((np.zeros((0, 3), np.float32), None))
            if t in (SEGMENT, POLYLINE):
                self.lines.append(i)

    def world_polys(self, poses_q: np.ndarray, poses_t: np.ndarray,
                    dynamic: np.ndarray):
        """Concatenate every body's transformed faces -> (tris, colors)."""
        tris, cols = [], []
        for i, (v, f) in enumerate(self.local):
            if f is None or len(v) == 0:
                continue
            w = _quat_rot(poses_q[i], v) + poses_t[i]
            tri = w[f]  # [F, 3, 3]
            tris.append(tri)
            h = poses_t[i][1]
            cols.append(np.full(len(tri), h if dynamic[i] else np.nan))
        if not tris:
            return np.zeros((0, 3, 3)), np.zeros((0,))
        return np.concatenate(tris), np.concatenate(cols)


def render_instanced(ax, inst: InstancedScene, poses_q, poses_t, dynamic,
                     lims):
    """Draw the scene as oriented meshes into a 3D axes."""
    from matplotlib import cm
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    tris, cols = inst.world_polys(poses_q, poses_t, dynamic)
    if len(tris):
        # height-colormapped dynamics, gray statics (matches the scatter
        # renderer's palette)
        lo, hi = lims
        t = np.clip((cols - lo) / max(hi - lo, 1e-6), 0, 1)
        rgba = cm.viridis(t)
        rgba[np.isnan(cols)] = (0.55, 0.55, 0.55, 1.0)
        rgba[:, 3] = np.where(np.isnan(cols), 0.3, 0.95)
        # matplotlib draws [x, z, y] to keep +Y up like the scenes
        pc = Poly3DCollection(tris[:, :, [0, 2, 1]], facecolors=rgba,
                              edgecolors="none")
        ax.add_collection3d(pc)
    ax.set_xlim(lims)
    ax.set_ylim(lims)
    ax.set_zlim(lims)
    ax.set_box_aspect((1, 1, 1))
