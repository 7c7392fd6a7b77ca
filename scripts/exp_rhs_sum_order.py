"""Which PyTorch formulation of the substep rhs matches the rhs rebuilt in
the ``gs_math.cu`` kernel bit for bit on the card?

For seeded inputs at one rung size the script runs the rhs-in-rung kernel
(``gs_math_block_rhs``, biased) and, for three PyTorch formulations of the
same rhs, the plain-rhs kernel (``gs_math_block``) fed with that rhs. The
two kernels share their point update, so every differing output element
comes from the rhs. Formulations: ``einsum`` (tangent bias by
``torch.einsum``, distance by ``torch.sum``), ``sum`` (both by
``torch.sum``), ``explicit`` (x0*y0 + x1*y1 + x2*y2, the kernels' order;
what ``constraint.update_rhs_sorted`` does).

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_rhs_sum_order.py
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import gs_math_inputs, nvidia_smi_line  # noqa: E402
from wgmath_tpu_torch.dynamics import gs_math  # noqa: E402
from wgmath_tpu_torch.geometry import sim as sim_ops  # noqa: E402
from wgmath_tpu_torch.geometry.sim import Sim  # noqa: E402


def dot_sum(a, b):
    return torch.sum(a * b, dim=-1)


def dot_explicit(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def rhs(f, pose1, pose2, consts, variant):
    inv_dt, erp, allowed, max_corr, _ = consts
    side1 = Sim(pose1[:, None, :4], pose1[:, None, 4:7], pose1[:, None, 7])
    side2 = Sim(pose2[:, None, :4], pose2[:, None, 4:7], pose2[:, None, 7])
    drift = (sim_ops.mul_pt(side1, f["local_pt_a"])
             - sim_ops.mul_pt(side2, f["local_pt_b"]))
    dot = dot_explicit if variant == "explicit" else dot_sum
    dist = f["info_dist"] + dot(drift, f["dir_a"][:, None, :])
    wo = f["info_normal_vel"] + torch.clamp(dist, min=0.0) * inv_dt
    bias = torch.clamp((dist + allowed) * erp, -max_corr, 0.0)
    if variant == "einsum":
        tb = torch.einsum("cpd,csd->cps", drift, f["tangent_a"]) * inv_dt
    else:
        tb = dot(drift[:, :, None, :], f["tangent_a"][:, None, :, :]) * inv_dt
    return wo + bias, wo, f["t_rhs_wo_bias"] + tb


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_rhs_sum_order: needs a CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    rng = np.random.default_rng(1)
    for L, p_max in ((4096, 1), (1024, 4)):
        args, kw = gs_math_inputs(rng, L, p_max, "biased", "cuda")
        win, meta, num_points, active, p1, p2, prev_n, prev_t = args
        in_kernel = gs_math.gs_math_block_rhs(*args, **kw)
        f = gs_math._fields(win, meta)
        for variant in ("einsum", "sum", "explicit"):
            n_rhs, wo, t_rhs = rhs(f, kw["pose1"], kw["pose2"],
                                   kw["consts"], variant)
            view = SimpleNamespace(
                cfm_factor=torch.full((L,), kw["consts"][4], device="cuda"),
                n_rhs=n_rhs, t_rhs=t_rhs, num_points=num_points)
            passed_in = gs_math.gs_math_block(
                win, meta, view, active, p1[:, :6], p2[:, :6], prev_n,
                prev_t, p_max=p_max, s_len=2)
            torch.cuda.synchronize()
            differ = [int((a != b).sum())
                      for a, b in zip(in_kernel[:4], passed_in)]
            print(f"L={L} P={p_max} {variant:8s} rhs_wo differs in "
                  f"{int((wo != in_kernel[4]).sum())}/{wo.numel()} "
                  f"elements; outputs (new_n, new_t, d1, d2) differ in "
                  f"{differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
