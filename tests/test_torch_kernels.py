"""The port's GS impulse math (``wgmath_tpu_torch.dynamics.gs_math``) against
the JAX package's ``gs_math_block_rhs``: the Pallas kernel run in interpret
mode and its plain XLA twin, on the same seeded inputs.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that version on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgmath_tpu.dynamics.gs_pallas import gs_math_block_rhs as jax_rhs
from wgmath_tpu_torch.dynamics import gs_math
from wgmath_tpu_torch.dynamics.gs_math import pack_meta

# the JAX package's tolerance for this math (test_cm_gs_math_matches_row_major)
RTOL, ATOL = 1e-4, 1e-5
S_LEN = 2
CONSTS = (240.0, 175.3, 1e-3, 10.0, 0.93)


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
def test_gs_math_plain_matches_jax(mode, p_max, L, use_pallas):
    x = _inputs(11 * p_max + L, L, p_max)
    want = _call(jax_rhs, jnp.asarray, x, mode, p_max,
                 use_pallas=use_pallas)
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
