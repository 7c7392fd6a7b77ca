"""Carry a physics state across as named numpy arrays.

:func:`state_to_arrays` flattens a state into ``{"bodies.poses.rotation":
..., "shapes.kind": ..., "bp_colors.gs_cmax": ..., ...}`` with the JAX
package's layouts and types (int32 integers, float32 reals). It reads the
fields by name only, so it accepts this package's ``PhysicsState`` and the
JAX package's alike; a mesh-backed shape set carries its vertex and
index buffers and its cluster boxes whole. :func:`state_from_arrays`
builds this package's state from such a dict. Keys outside the state are ignored, so one ``.npz``
can carry a state beside other arrays; :func:`load_arrays` reads such a
file (``.npz``, or an ``.npz`` compressed whole with xz, ``.npz.xz``).

The queries take a shape set and the colliders' poses:
:func:`shapes_to_arrays` / :func:`shapes_from_arrays` and
:func:`sim_to_arrays` / :func:`sim_from_arrays` carry a ``ShapeSet`` and a
``Sim`` (component-major storage included) across the same way, from
either package.

The linear-algebra layer (``ops/``, ``core/tensor.py``) has no parameters
and no state besides its operands, so it needs nothing here: a ``View`` is
built from an array by ``core.tensor.view_of`` and read back by its
``to_array``.
"""

from __future__ import annotations

import dataclasses
import io
import lzma

import numpy as np
import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.dynamics.body import (
    Bodies,
    LocalMassProperties,
    Velocity,
)
from wgmath_tpu_torch.dynamics.constraint import ContactConstraints
from wgmath_tpu_torch.dynamics.joint import JOINT_FIELDS, JointSet
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import PhysicsState
from wgmath_tpu_torch.shapes.shape import ShapeSet

_BODY_FIELDS = {
    "bodies.poses.rotation": ("poses", "rotation"),
    "bodies.poses.translation": ("poses", "translation"),
    "bodies.poses.scale": ("poses", "scale"),
    "bodies.vels.linear": ("vels", "linear"),
    "bodies.vels.angular": ("vels", "angular"),
    "bodies.local_mprops.inv_mass": ("local_mprops", "inv_mass"),
    "bodies.local_mprops.com": ("local_mprops", "com"),
    "bodies.local_mprops.inertia_ref_frame": ("local_mprops",
                                              "inertia_ref_frame"),
    "bodies.local_mprops.inv_principal_inertia": ("local_mprops",
                                                  "inv_principal_inertia"),
}
_CONSTRAINT_FIELDS = tuple(f.name for f in
                           dataclasses.fields(ContactConstraints))
_BP_COLOR_KEYS = ("colors", "gs_cmax", "max_colors", "slot_flag")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return a
    if np.issubdtype(a.dtype, np.integer):
        return a.astype(np.int32)
    return a.astype(np.float32)


def _tensor(a, dev) -> torch.Tensor:
    """int64 for integers, bool for masks, float32 otherwise."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(dev)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


_SHAPE_FIELDS = ("tag", "params", "vertices", "indices", "cluster_min",
                 "cluster_max")


def shapes_to_arrays(shapes) -> dict[str, np.ndarray]:
    """A shape set (this package's or the JAX package's) as named numpy
    arrays: the six buffers and ``kinds`` as a sorted int32 vector."""
    out = {f: _np(getattr(shapes, f)) for f in _SHAPE_FIELDS}
    out["kinds"] = np.asarray(sorted(shapes.kinds), np.int32)
    return out


def shapes_from_arrays(arrays: dict, device=None) -> ShapeSet:
    """This package's shape set from :func:`shapes_to_arrays` output.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    return ShapeSet(*(_tensor(arrays[f], dev) for f in _SHAPE_FIELDS),
                    kinds=frozenset(int(k) for k in arrays["kinds"]))


def sim_to_arrays(sim) -> dict[str, np.ndarray]:
    """A ``Sim`` (either package's) as named numpy arrays. Component-major
    storage keeps its rows stacked as ``[C, N]`` and sets ``cm``."""
    def rows(x):
        return np.stack([_np(r) for r in x]) if sim.cm else _np(x)

    return {"rotation": rows(sim.rotation),
            "translation": rows(sim.translation),
            "scale": _np(sim.scale), "cm": np.asarray(bool(sim.cm))}


def sim_from_arrays(arrays: dict, device=None) -> Sim:
    """This package's ``Sim`` from :func:`sim_to_arrays` output.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    cm = bool(arrays.get("cm", False))
    rot, tra = (_tensor(arrays[k], dev) for k in ("rotation", "translation"))
    if cm:
        rot, tra = tuple(rot), tuple(tra)
    return Sim(rot, tra, _tensor(arrays["scale"], dev), cm=cm)


def joints_to_arrays(joints) -> dict[str, np.ndarray]:
    """A joint set (this package's or the JAX package's) as named numpy
    arrays: each field, the local frames as ``local_frame_a.rotation``
    and so on."""
    out = {}
    for f in JOINT_FIELDS:
        v = getattr(joints, f)
        if f.startswith("local_frame"):
            for part in ("rotation", "translation", "scale"):
                out[f"{f}.{part}"] = _np(getattr(v, part))
        else:
            out[f] = _np(v)
    return out


def joints_from_arrays(arrays: dict, device=None) -> JointSet:
    """This package's joint set from :func:`joints_to_arrays` output (its
    host values are computed as it is made). ``device=None`` means the
    card."""
    dev = resolve_device(device)
    vals = {}
    for f in JOINT_FIELDS:
        if f.startswith("local_frame"):
            vals[f] = Sim(*(_tensor(arrays[f"{f}.{part}"], dev) for part in
                            ("rotation", "translation", "scale")))
        else:
            vals[f] = _tensor(arrays[f], dev)
    return JointSet(**vals)


def state_to_arrays(state) -> dict[str, np.ndarray]:
    """Named numpy arrays of a physics state (this package's or the JAX
    package's). Optional parts that are absent are left out."""
    out = {}
    b = state.bodies
    for key, (grp, field) in _BODY_FIELDS.items():
        v = getattr(getattr(b, grp), field)
        if v is not None:  # a 2D body has no inertia frame
            out[key] = _np(v)
    if getattr(b, "kinematic", None) is not None:
        out["bodies.kinematic"] = _np(b.kinematic)
    s = state.shapes
    out["shapes.tag"] = _np(s.tag)
    out["shapes.params"] = _np(s.params)
    out["shapes.kind"] = np.asarray(sorted(s.kinds), np.int32)
    if s.vertices.shape[0] or s.cluster_min.shape[0]:
        # a mesh-backed set: its shared buffers and cluster boxes whole
        for f in _SHAPE_FIELDS[2:]:
            out[f"shapes.{f}"] = _np(getattr(s, f))
    out["pair_count"] = _np(state.pair_count)
    if state.prev_constraints is not None:
        for f in _CONSTRAINT_FIELDS:
            out[f"prev_constraints.{f}"] = _np(
                getattr(state.prev_constraints, f))
    if state.prev_colors is not None:
        out["prev_colors"] = _np(state.prev_colors)
    if state.bp_pairs is not None:
        for f in ("body_a", "body_b", "valid", "count"):
            out[f"bp_pairs.{f}"] = _np(getattr(state.bp_pairs, f))
    if state.bp_ref is not None:
        out["bp_ref.mins"] = _np(state.bp_ref[0])
        out["bp_ref.maxs"] = _np(state.bp_ref[1])
    if state.bp_colors is not None:
        for k, v in zip(_BP_COLOR_KEYS, state.bp_colors):
            out[f"bp_colors.{k}"] = _np(v)
    if state.solve_cache is not None:
        for i, v in enumerate(state.solve_cache):
            out[f"solve_cache.{i}"] = _np(v)
    if state.joints is not None:
        for k, v in joints_to_arrays(state.joints).items():
            out[f"joints.{k}"] = v
    return out


def load_arrays(path: str) -> dict:
    """Every array of an ``.npz`` file by name, or of an ``.npz.xz`` file
    (an uncompressed ``.npz`` compressed whole with xz)."""
    if path.endswith(".xz"):
        with lzma.open(path) as f:
            path = io.BytesIO(f.read())
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def state_from_arrays(arrays: dict, device=None) -> PhysicsState:
    """This package's state from :func:`state_to_arrays` output.
    ``device=None`` means the card. Integers become int64, masks bool."""
    dev = resolve_device(device)

    def t(key):
        return _tensor(arrays[key], dev)

    g = {k: t(k) if k in arrays else None for k in _BODY_FIELDS}
    bodies = Bodies(
        Sim(g["bodies.poses.rotation"], g["bodies.poses.translation"],
            g["bodies.poses.scale"]),
        Velocity(g["bodies.vels.linear"], g["bodies.vels.angular"]),
        LocalMassProperties(
            g["bodies.local_mprops.inv_mass"], g["bodies.local_mprops.com"],
            g["bodies.local_mprops.inertia_ref_frame"],
            g["bodies.local_mprops.inv_principal_inertia"]),
        t("bodies.kinematic").to(torch.bool)
        if "bodies.kinematic" in arrays else None)
    dim = g["bodies.poses.translation"].shape[-1]
    buffers = ((t("shapes.vertices"), t("shapes.indices"),
                t("shapes.cluster_min"), t("shapes.cluster_max"))
               if "shapes.vertices" in arrays else
               (torch.zeros((0, dim), device=dev),
                torch.zeros((0, dim), dtype=torch.int64, device=dev)))
    shapes = ShapeSet(
        t("shapes.tag"), t("shapes.params"), *buffers,
        kinds=frozenset(int(k) for k in np.asarray(arrays["shapes.kind"])))
    prev = None
    if "prev_constraints.body_a" in arrays:
        prev = ContactConstraints(
            **{f: t(f"prev_constraints.{f}") for f in _CONSTRAINT_FIELDS})
    bp_pairs = None
    if "bp_pairs.body_a" in arrays:
        bp_pairs = PairList(*(t(f"bp_pairs.{f}") for f in
                              ("body_a", "body_b", "valid", "count")))
    bp_ref = None
    if "bp_ref.mins" in arrays:
        bp_ref = (t("bp_ref.mins"), t("bp_ref.maxs"))
    bp_colors = None
    if "bp_colors.colors" in arrays:
        bp_colors = (t("bp_colors.colors"),) + tuple(
            int(np.asarray(arrays[f"bp_colors.{k}"]))
            for k in _BP_COLOR_KEYS[1:] if f"bp_colors.{k}" in arrays)
    solve_cache = None
    if "solve_cache.0" in arrays:
        n_cache = sum(1 for k in arrays if k.startswith("solve_cache."))
        solve_cache = tuple(t(f"solve_cache.{i}") for i in range(n_cache))
    joints = None
    if "joints.body_a" in arrays:
        joints = joints_from_arrays(
            {k[len("joints."):]: v for k, v in arrays.items()
             if k.startswith("joints.")}, dev)
    return PhysicsState(
        bodies, shapes, prev, t("pair_count"),
        t("prev_colors") if "prev_colors" in arrays else None,
        bp_pairs, bp_ref, bp_colors, solve_cache, joints)
