"""The port's GS impulse math (``wgmath_tpu_torch.dynamics.gs_math``) against
the JAX package's ``gs_math_block_rhs`` and ``gs_math_block``: each Pallas
kernel run in interpret mode and its plain XLA twin, on the same seeded
inputs. The JAX package's outputs are read from
``artifacts/torch_kernels_jax.npz.xz`` (``JAX_PLATFORMS=cpu python
scripts/export_port_tests_npz.py --only kernels`` rewrites it from this
file's input helpers), so this file imports no JAX.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that version on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import load_arrays
from wgmath_tpu_torch.dynamics import gs_math
from wgmath_tpu_torch.dynamics.gs_math import UPDATE_FIELDS, pack_meta

# the JAX package's tolerance for this math (test_cm_gs_math_matches_row_major)
RTOL, ATOL = 1e-4, 1e-5
S_LEN = 2
CONSTS = (240.0, 175.3, 1e-3, 10.0, 0.93)
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "torch_kernels_jax.npz.xz")
RHS_CASES = [(mode, p_max, L) for mode in ("biased", "unbiased")
             for p_max in (1, 4) for L in (256, 200)]
BLOCK_CASES = [(layout, p_max, L) for layout in ("full", "update_only")
               for p_max in (1, 4) for L in (256, 200)]


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def xor_impulses(outs, x, dtype) -> list:
    """``outs`` with outputs 0 and 1 (the new impulses) XOR the previous
    impulses ``x["prev_n"]`` / ``x["prev_t"]`` bit for bit, viewed as
    ``dtype``: JAX's outputs as the file stores them (uint32; most rows
    keep their impulses, so their words are 0) and back (float32)."""
    out = list(outs)
    for i, prev in ((0, x["prev_n"]), (1, x["prev_t"])):
        out[i] = (out[i].view(np.uint32) ^ prev.view(np.uint32)).view(dtype)
    return out


def _stored(z, pre: str, use_pallas: bool, x) -> list:
    """JAX's outputs of case ``pre`` (inputs ``x``) on one route."""
    route = "pallas" if use_pallas else "xla"
    out, i = [], 0
    while f"{pre}.{route}.{i}" in z:
        out.append(z[f"{pre}.{route}.{i}"])
        i += 1
    return xor_impulses(out, x, np.float32)


def _inputs(seed, L, p_max):
    """Seeded numpy inputs; the friction mass matrix [r0, r1, cross] is
    positive definite and the poses are unit quaternions, as in a real
    solve."""
    rng = np.random.default_rng(seed)
    meta = pack_meta(p_max, S_LEN)
    k = sum(int(np.prod(t)) if t else 1 for _, t in meta.values())
    win = rng.normal(size=(L, k)).astype(np.float32)

    def put(name, vals):
        at, _ = meta[name]
        win[:, at:at + vals.shape[1]] = vals

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, (L,) + shape).astype(np.float32)

    put("im_a", u(0.0, 2.0, 3))
    put("im_b", u(0.0, 2.0, 3))
    put("limit", u(0.0, 1.0, 1))
    put("n_r", u(0.1, 2.0, p_max))
    put("t_r", np.concatenate([u(0.5, 1.5, p_max, 2),
                               u(-0.5, 0.5, p_max, 1)], -1).reshape(L, -1))
    put("local_pt_a", u(-0.5, 0.5, p_max * 3))
    put("local_pt_b", u(-0.5, 0.5, p_max * 3))
    put("info_dist", u(-0.05, 0.02, p_max))

    def pose():
        q = rng.normal(size=(L, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        return np.concatenate([q, rng.normal(size=(L, 3)) * 0.01,
                               rng.uniform(0.9, 1.1, (L, 1))],
                              -1).astype(np.float32)

    return dict(
        win2d=win, meta=meta,
        num_points=rng.integers(0, p_max + 1, L).astype(np.int32),
        active=rng.random(L) > 0.2,
        p1=rng.normal(size=(L, 6)).astype(np.float32),
        p2=rng.normal(size=(L, 6)).astype(np.float32),
        prev_n=rng.uniform(0.0, 0.5, (L, p_max)).astype(np.float32),
        prev_t=rng.normal(scale=0.1, size=(L, p_max, S_LEN)).astype(
            np.float32),
        pose1=pose(), pose2=pose(),
        n_rhs_wo=rng.normal(size=(L, p_max)).astype(np.float32))


def _call(fn, conv, x, mode, p_max, **extra):
    kw = dict(mode=mode, consts=CONSTS, p_max=p_max, s_len=S_LEN, **extra)
    if mode == "biased":
        kw.update(pose1=conv(x["pose1"]), pose2=conv(x["pose2"]))
    else:
        kw.update(n_rhs_wo=conv(x["n_rhs_wo"]))
    return fn(conv(x["win2d"]), x["meta"], conv(x["num_points"]),
              conv(x["active"]), conv(x["p1"]), conv(x["p2"]),
              conv(x["prev_n"]), conv(x["prev_t"]), **kw)


def _torch(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.int64) if t.dtype == torch.int32 else t


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("L", [256, 200])
@pytest.mark.parametrize("p_max", [1, 4])
@pytest.mark.parametrize("mode", ["biased", "unbiased"])
def test_gs_math_plain_matches_jax(z, mode, p_max, L, use_pallas):
    x = _inputs(11 * p_max + L, L, p_max)
    want = _stored(z, f"rhs.{mode}.{p_max}.{L}", use_pallas, x)
    launches = gs_math.LAUNCHES
    got = _call(gs_math.gs_math_block_rhs, _torch, x, mode, p_max)
    assert gs_math.LAUNCHES == launches, "CPU tensors never launch"
    assert len(got) == len(want) == (5 if mode == "biased" else 4)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_gs_math_wrapper_refuses_uninstantiated_shapes():
    """The launcher checks what the kernel takes before touching a device:
    only P in {1, 4} with S = 2 is instantiated, and every packed field must
    be present at its shape."""
    x = _inputs(3, 128, 2)
    t = {k: _torch(v) for k, v in x.items() if k != "meta"}
    with pytest.raises(ValueError, match="not instantiated"):
        gs_math._launch(t["win2d"], x["meta"], t["num_points"], t["active"],
                        t["p1"], t["p2"], t["prev_n"], t["prev_t"],
                        mode="biased", consts=CONSTS, pose1=t["pose1"],
                        pose2=t["pose2"], n_rhs_wo=None, p_max=2,
                        s_len=S_LEN)
    x = _inputs(4, 128, 1)
    t = {k: _torch(v) for k, v in x.items() if k != "meta"}
    meta = dict(x["meta"])
    del meta["t_r"]
    with pytest.raises(ValueError, match="t_r"):
        gs_math._launch(t["win2d"], meta, t["num_points"], t["active"],
                        t["p1"], t["p2"], t["prev_n"], t["prev_t"],
                        mode="biased", consts=CONSTS, pose1=t["pose1"],
                        pose2=t["pose2"], n_rhs_wo=None, p_max=1,
                        s_len=S_LEN)


def _block_inputs(seed, L, p_max, layout):
    """Inputs of ``gs_math_block``: the packed window plus the per-substep
    ``cfm_factor`` / ``n_rhs`` / ``t_rhs``. ``layout`` "full" is the
    66-column matrix of the rhs-in-rung kernel; "update_only" packs just
    the fields the point update reads, in another column order, so the
    column offsets must come from ``meta``."""
    x = _inputs(seed, L, p_max)
    rng = np.random.default_rng(seed + 1)
    if layout == "update_only":
        full, src = x["meta"], x["win2d"]
        meta, cols, at = {}, [], 0
        for name in reversed(UPDATE_FIELDS):
            a0, tail = full[name]
            k = int(np.prod(tail)) if tail else 1
            meta[name] = (at, tail)
            cols.append(src[:, a0:a0 + k])
            at += k
        x["meta"], x["win2d"] = meta, np.concatenate(cols, axis=1)
    x["cfm_factor"] = rng.uniform(0.5, 1.0, L).astype(np.float32)
    x["n_rhs"] = rng.normal(size=(L, p_max)).astype(np.float32)
    x["t_rhs"] = rng.normal(size=(L, p_max, S_LEN)).astype(np.float32)
    return x


def _call_block(fn, conv, x, p_max, **extra):
    view = SimpleNamespace(**{k: conv(x[k]) for k in
                              ("cfm_factor", "n_rhs", "t_rhs",
                               "num_points")})
    return fn(conv(x["win2d"]), x["meta"], view, conv(x["active"]),
              conv(x["p1"]), conv(x["p2"]), conv(x["prev_n"]),
              conv(x["prev_t"]), p_max=p_max, s_len=S_LEN, **extra)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("layout", ["full", "update_only"])
@pytest.mark.parametrize("L", [256, 200])
@pytest.mark.parametrize("p_max", [1, 4])
def test_gs_math_block_plain_matches_jax(z, p_max, L, layout, use_pallas):
    x = _block_inputs(13 * p_max + L, L, p_max, layout)
    want = _stored(z, f"block.{layout}.{p_max}.{L}", use_pallas, x)
    launches = gs_math.LAUNCHES_BLOCK
    got = _call_block(gs_math.gs_math_block, _torch, x, p_max)
    assert gs_math.LAUNCHES_BLOCK == launches, "CPU tensors never launch"
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # an inactive row returns its previous impulses bit for bit
    off = ~x["active"]
    np.testing.assert_array_equal(got[0].numpy()[off], x["prev_n"][off])
    np.testing.assert_array_equal(got[1].numpy()[off], x["prev_t"][off])


def test_gs_math_block_wrapper_refuses_uninstantiated_shapes():
    x = _block_inputs(5, 128, 2, "full")
    t = {k: _torch(v) for k, v in x.items() if k != "meta"}
    args = lambda meta: (t["win2d"], meta, t["cfm_factor"], t["n_rhs"],
                         t["t_rhs"], t["num_points"], t["active"], t["p1"],
                         t["p2"], t["prev_n"], t["prev_t"])
    with pytest.raises(ValueError, match="not instantiated"):
        gs_math._launch_block(*args(x["meta"]), p_max=2, s_len=S_LEN)
    x = _block_inputs(6, 128, 1, "update_only")
    t = {k: _torch(v) for k, v in x.items() if k != "meta"}
    meta = dict(x["meta"])
    meta["t_r"] = (t["win2d"].shape[1] - 1, (1, 3))
    with pytest.raises(ValueError, match="t_r lies outside"):
        gs_math._launch_block(*args(meta), p_max=1, s_len=S_LEN)
