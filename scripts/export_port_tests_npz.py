"""Export the JAX package's half of two of the port's CPU test files as
JAX-free ``.npz`` files, so those tests run only the port:

- ``artifacts/torch_ladder_jax.npz`` for ``tests/test_torch_ladder.py``:
  the JAX constraints of the seeded solver setups (seeds 4, 0 and 1), and
  JAX's contact compaction, rhs relinearization, CFM removal, colour
  layout and field sort, field packing, sorted-sides warmstart and one
  ladder and one chained sweep on the test's inputs;
- ``artifacts/torch_fused_jax.npz`` for ``tests/test_torch_fused.py``:
  JAX's static rung-padded compaction, field layout, fused constraint
  build (the XLA route and, in one case, the Pallas kernel in interpret
  mode), per-colour tables, and the fused sweep, substep opening and pose
  update, each on its XLA twin and, where the test holds it, the Pallas
  kernel in interpret mode.

The inputs come from the test modules' own helpers (numpy ``default_rng``
draws, no JAX), so the stored results are of the inputs the tests build.
Every JAX call is the one the test made before it read this file. Runs on
the CPU (~2 min with a cold JAX cache)::

    JAX_PLATFORMS=cpu python scripts/export_port_tests_npz.py [--only ladder|fused]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from wgmath_tpu.dynamics import SimParams as JaxSimParams  # noqa: E402
from wgmath_tpu.dynamics import body as jbody  # noqa: E402
from wgmath_tpu.dynamics import build_pallas as jbuild  # noqa: E402
from wgmath_tpu.dynamics import constraint as jcons  # noqa: E402
from wgmath_tpu.dynamics import gs_fused as jfused  # noqa: E402
from wgmath_tpu.dynamics import solver as jsolver  # noqa: E402
from wgmath_tpu.geometry import sim as jsim  # noqa: E402

OUT = {"ladder": os.path.join(ROOT, "artifacts", "torch_ladder_jax.npz"),
       "fused": os.path.join(ROOT, "artifacts", "torch_fused_jax.npz")}


def _np(x):
    return np.asarray(x)


def _contacts_j(contact):
    return jcons.Contacts(**{k: jnp.asarray(v) for k, v in contact.items()})


def _jax_setup(x):
    """``tests.test_torch_solver._solver_setup``'s JAX half."""
    jmp = jbody.ball_local_mprops(jnp.asarray(x["radii"]),
                                  dynamic=jnp.asarray(x["dyn"]))
    jposes = jsim.Sim(jnp.asarray(x["q"]), jnp.asarray(x["tr"]),
                      jnp.ones(x["n"]))
    jvels = jbody.Velocity(jnp.asarray(x["lin"]), jnp.asarray(x["ang"]))
    jc = jcons.build_constraints(
        jposes, jvels, jbody.update_mprops(jposes, jmp),
        _contacts_j(x["contact"]), JaxSimParams())
    return jbody.Bodies(jposes, jvels, jmp), jc


def ladder() -> dict:
    from tests import test_torch_ladder as t
    from tests.test_torch_solver import _solver_inputs

    out = {}
    setups = {}
    for seed in t.SEEDS:
        x = _solver_inputs(seed=seed)
        jb, jc = _jax_setup(x)
        setups[seed] = (x, jb, jc)
        for f in t._CONSTRAINT_FIELDS:
            out[f"setup.{seed}.jc.{f}"] = _np(getattr(jc, f))
    x, jb, jc = setups[4]

    contact, colors = t._contacts(7)
    for branch, capacity in t.COMPACT_CASES:
        kw = t.compact_kw(branch, colors)
        want = jcons.compact_contacts(
            _contacts_j(contact), capacity,
            **{k: jnp.asarray(v) if k == "extra" else v
               for k, v in kw.items()})
        pre = f"compact.{branch}.{capacity}"
        out[f"{pre}.len"] = np.int32(len(want))
        out[f"{pre}.count"] = _np(want[1])
        for f in dataclasses.fields(jcons.Contacts):
            out[f"{pre}.{f.name}"] = _np(getattr(want[0], f.name))
        if len(want) > 2:
            out[f"{pre}.extra"] = _np(want[2])

    q, tr = t.moved_poses(x["q"], x["tr"])
    want = jcons.update_rhs_sorted(
        jc, jsim.Sim(jnp.asarray(q), jnp.asarray(tr), jnp.ones(x["n"])),
        JaxSimParams().substep())
    out["update_rhs.len"] = np.int32(len(want))
    for i, w in enumerate(want):
        out[f"update_rhs.{i}"] = _np(w)

    want = jcons.remove_cfm_and_bias(jc)
    for f in ("n_rhs", "t_rhs", "cfm_factor", "n_rhs_wo_bias"):
        out[f"remove_cfm.{f}"] = _np(getattr(want, f))

    perm, colors = t.shuffle(x)
    jcp = dataclasses.replace(jc, **{
        f.name: jnp.asarray(_np(getattr(jc, f.name))[perm])
        for f in dataclasses.fields(jc)})
    mc, cmax = x["max_colors"], max(x["windows"])
    layout = jsolver.build_color_layout(jnp.asarray(colors), jcp.valid,
                                        max_colors=mc, cmax=cmax)
    for i, w in enumerate(layout):
        out[f"layout.{i}"] = _np(w)
    jss, (jpf, jmeta) = jsolver.sort_solver_fields_packed(jcp, layout[0])
    out["sorted.meta_json"] = np.asarray(json.dumps(
        {k: [a, list(tl)] for k, (a, tl) in jmeta.items()}))
    out["sorted.pf"] = _np(jpf)
    out["sorted.fields_json"] = np.asarray(json.dumps(list(vars(jss))))
    for f in vars(jss):
        out[f"sorted.{f}"] = _np(getattr(jss, f))

    jpf, jmeta = jsolver.pack_sorted_fields(jc)
    out["pack.pf"] = _np(jpf)
    out["pack.meta_json"] = np.asarray(json.dumps(
        {k: [a, list(tl)] for k, (a, tl) in jmeta.items()}))

    imp_n, imp_t = t.warm_impulses(x)
    jcw = dataclasses.replace(jc, n_impulse=jnp.asarray(imp_n),
                              t_impulse=jnp.asarray(imp_t))
    jsides = jsolver.build_sorted_sides(jcw, x["n"])
    for i, w in enumerate(jsides):
        out[f"sides.{i}"] = _np(w)
    want = jsolver.warmstart_apply_sorted(jcw, jb.vels, jsides)
    out["warm.linear"], out["warm.angular"] = (_np(want.linear),
                                               _np(want.angular))

    s = t.sweep_arrays(x)
    jss, jpf = jsolver.pad_solver_fields_packed(dataclasses.replace(
        jc, t_rhs=jnp.asarray(s.t_rhs), cfm_factor=jnp.asarray(s.cfm)),
        s.cmax)
    for mode in ("ladder", "chained"):
        jchain = None
        if mode == "chained":
            dyn = x["dyn"]
            ba, bb = _np(jss.body_a), _np(jss.body_b)
            jchain = jsolver.build_gs_chain(
                jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(dyn[ba]),
                jnp.asarray(dyn[bb]), jnp.asarray(s.off, jnp.int32),
                jnp.asarray(s.cnt, jnp.int32), s.windows, x["n"])
        layout = (jnp.zeros(s.total, jnp.int32),
                  jnp.asarray(s.off, jnp.int32),
                  jnp.asarray(s.cnt, jnp.int32))
        jv, jn, jt = jsolver.gs_color_major_pass(
            jss, jb.vels, jnp.asarray(s.n_s), jnp.asarray(s.t_s), layout,
            jnp.int32(len(s.windows)), cmax=s.cmax, dim=3,
            packed_fields=jpf, windows=s.windows, chain=jchain)
        for key, w in (("linear", jv.linear), ("angular", jv.angular),
                       ("n", jn), ("t", jt)):
            out[f"sweep.{mode}.{key}"] = _np(w)
    return out


def _meta_json(meta) -> np.ndarray:
    return np.asarray(json.dumps({k: [a, list(tl)]
                                  for k, (a, tl) in meta.items()}))


def _jit(fn, **static):
    """One jitted JAX call: the keyword arguments are closed over."""
    return jax.jit(functools.partial(fn, **static))


def _store_compaction(out, pre, want):
    out[f"{pre}.len"] = np.int32(len(want))
    for f in dataclasses.fields(jcons.Contacts):
        out[f"{pre}.{f.name}"] = _np(getattr(want[0], f.name))
    out[f"{pre}.count"] = _np(want[1])
    out[f"{pre}.colors"] = _np(want[2])
    out[f"{pre}.class_counts"] = _np(want[3])


def fused() -> dict:
    from tests import test_torch_fused as t

    out = {}
    contact, colors = t.static_inputs()
    for rung in t.STATIC_RUNGS:
        _store_compaction(out, f"static.{rung}", jcons.compact_contacts(
            _contacts_j(contact), 0, extra=jnp.asarray(colors),
            sort_by_extra=True, static_windows=(rung,) * 9))
    for p_max in (1, 4):
        meta, k = jbuild.field_meta(p_max, t.S_LEN)
        out[f"meta.{p_max}.json"] = _meta_json(meta)
        out[f"meta.{p_max}.k"] = np.int32(k)

    for case, (p_max, rung0, n_pairs, max_colors) in t.CASES.items():
        pre = f"setup.{case}"
        x = t.setup_inputs(5 + p_max + rung0, p_max, n_pairs)
        n, dyn = x["n"], x["dyn"]
        ba, bb = x["ba"], x["bb"]
        colors = _np(jsolver.color_pairs(
            jnp.asarray(ba), jnp.asarray(bb),
            jnp.asarray(x["contact"]["valid"]), jnp.asarray(dyn[ba]),
            jnp.asarray(dyn[bb]), n, max_colors=max_colors, claim_rounds=4,
            class_cap=14))
        out[f"{pre}.colors"] = colors
        cc, windows = t.rungs(colors, x["contact"]["valid"], max_colors)
        want = jcons.compact_contacts(
            _contacts_j(x["contact"]), 0, extra=jnp.asarray(colors),
            sort_by_extra=True, static_windows=(rung0,) + windows)
        _store_compaction(out, f"{pre}.compact", want)
        jposes = jsim.Sim(jnp.asarray(x["q"]), jnp.asarray(x["tr"]),
                          jnp.ones(n))
        jvels = jbody.Velocity(jnp.asarray(x["lin"]), jnp.asarray(x["ang"]))
        jmp = jbody.update_mprops(jposes, jbody.ball_local_mprops(
            jnp.asarray(x["radii"]), dynamic=jnp.asarray(dyn)))
        routes = t.jax_routes(p_max, rung0)
        builds = {}
        for use_pallas in routes:
            route = "pallas" if use_pallas else "xla"
            j_cons, j_big, j_meta = jbuild.build_constraints_fused(
                jposes, jvels, jmp, want[0], JaxSimParams(),
                use_pallas=use_pallas)
            builds[route] = (j_cons, _np(j_big), j_meta)
            for f in t._BUILD_FIELDS:
                out[f"{pre}.build.{route}.{f}"] = _np(getattr(j_cons, f))
            out[f"{pre}.build.{route}.big"] = _np(j_big)
            out[f"{pre}.build.{route}.meta_json"] = _meta_json(j_meta)
        j_cons, j_big, j_meta = builds["xla"]
        w_g = jfused.gather_width(n, windows)
        out[f"{pre}.w_g"] = np.int32(w_g)
        dyn_a = jnp.any(j_cons.im_a != 0.0, axis=-1)
        dyn_b = jnp.any(j_cons.im_b != 0.0, axis=-1)
        j_idx, j_inv = jfused.build_fused_tables(
            j_cons.body_a, j_cons.body_b, dyn_a, dyn_b, j_cons.valid,
            windows=windows, rung0=rung0, w_g=w_g)
        out[f"{pre}.idx"], out[f"{pre}.inv"] = _np(j_idx), _np(j_inv)

        meta, k_pack, src0, src_meta = t.sweep_layout(
            {k: (a, tuple(tl)) for k, (a, tl) in j_meta.items()})
        ctot = j_big.shape[1]
        counts = jnp.asarray(np.concatenate([cc, [0]]).astype(np.int32))
        active = jnp.asarray(np.asarray(j_cons.valid, np.float32)[None])
        nump = jnp.asarray(np.asarray(j_cons.num_points, np.float32)[None])
        win, src = jnp.asarray(j_big[:k_pack]), jnp.asarray(j_big[src0:])
        kw = dict(windows=windows, rung0=rung0, p_max=p_max, s_len=t.S_LEN)

        def sweep_args(a, vt):
            return [jnp.asarray(vt), jnp.asarray(a["n_imp"]),
                    jnp.asarray(a["t_imp"]), win, active, nump, 0.93,
                    jnp.asarray(a["n_rhs"]), jnp.asarray(a["t_rhs"]),
                    j_idx, j_inv, counts]

        a1 = t.sweep_arrays(p_max, n, x["q"], x["tr"], ctot, w_g, 1)
        a2 = t.sweep_arrays(p_max, n, x["q"], x["tr"], ctot, w_g, 2)
        vt_c, com = t.carry_inputs(a1["vt"])
        for use_pallas in routes:
            route = "pallas" if use_pallas else "xla"
            sweep = _jit(jfused.fused_sweep, meta=meta,
                         use_pallas=use_pallas, **kw)
            for i, w in enumerate(sweep(*sweep_args(a1, a1["vt"]))):
                out[f"{pre}.sweep.{route}.{i}"] = _np(w)
            for i, w in enumerate(sweep(*sweep_args(a1, vt_c))):
                out[f"{pre}.carry.sweep.{route}.{i}"] = _np(w)
            sub = _jit(jfused.fused_substep1, meta=meta, src_meta=src_meta,
                       scalars=t.SUBSTEP_SCALARS, use_pallas=use_pallas,
                       **kw)
            res = sub(jnp.asarray(a2["vt"]), jnp.asarray(a2["n_imp"]),
                      jnp.asarray(a2["t_imp"]), win, src,
                      jnp.asarray(a2["pose"]), active, nump, j_idx, j_inv,
                      counts)
            for i, w in enumerate(res):
                out[f"{pre}.substep.{route}.{i}"] = _np(w)
        for use_pallas in (False, True):
            route = "pallas" if use_pallas else "xla"
            out[f"{pre}.carry.integrate.{route}"] = _np(_jit(
                jfused.fused_integrate, dt=t.INTEGRATE_DT,
                use_pallas=use_pallas)(jnp.asarray(a1["pose"]),
                                       jnp.asarray(vt_c), jnp.asarray(com)))
        print(f"fused case {case} done", flush=True)

    pose, vt, com = t.integrate_inputs()
    for use_pallas in (False, True):
        route = "pallas" if use_pallas else "xla"
        out[f"integrate.{route}"] = _np(_jit(
            jfused.fused_integrate, dt=t.INTEGRATE_DT,
            use_pallas=use_pallas)(jnp.asarray(pose), jnp.asarray(vt),
                                   jnp.asarray(com)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(OUT), default=None)
    only = ap.parse_args().only
    for name, fn in (("ladder", ladder), ("fused", fused)):
        if only not in (None, name):
            continue
        t0 = time.time()
        arrays = fn()
        np.savez_compressed(OUT[name], **arrays)
        print(f"wrote {OUT[name]} ({os.path.getsize(OUT[name]) / 1e6:.2f} "
              f"MB, {time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
