"""What does carrying B12 cost B10 inside the fused step?

The `fused` step hands B12's pose update (``fused_integrate``) to B10's
opening (``fused_sweep(..., integrate=...)``). This script steps the
settled 10k pit under the stored ``fused`` configuration (six warm frames,
then profiled windows of four frames) in four plans, in turns:

- ``carried``: the step as it is, B10 carrying B12;
- ``standalone``: B12 launched on its own before a B10 that carries
  nothing, the same build of ``csrc/gs_fused.cu``;
- ``no integrate in B10``: the same, with a build of ``gs_fused.cu`` whose
  B10 opening has no integrate call (so the kernel keeps no code and no
  stack frame for it);
- ``carried, __sinf / __cosf``: a diagnostic build, carried as in the
  step, with the intrinsics in place of the precise ``sinf`` / ``cosf``,
  which have no slow range reduction and so no stack frame (other bits:
  not a candidate, B12 is held to 2 ulp).

For each it prints B10's device time a launch inside the step and the
step's device kernel time (``chip_smoke.profile_window``), and the medians
over the windows; then the pit's first B10 alone, carrying B12 or not, in
turns (``chip_smoke.paired_ms``).

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_fused_integrate_step.py
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from wgmath_tpu_torch.convert import state_from_arrays  # noqa: E402
from wgmath_tpu_torch.core import cuda_build  # noqa: E402
from wgmath_tpu_torch.dynamics import gs_fused, solver  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402

WINDOWS = 6  # profiled windows per plan
CALL = ("    if (integrate) integrate_lane(p, v, v + 3, a.dt, a.pose_out, "
        "a.w_g, b);\n")


EDITS = {"no integrate in B10": [(CALL, "")],
         "carried, __sinf / __cosf": [
             (": sinf(half) / fmaxf(angle, 1e-30f);",
              ": __sinf(half) / fmaxf(angle, 1e-30f);"),
             ("                       cosf(half)};",
              "                       __cosf(half)};")]}


def _build(name: str) -> ctypes.CDLL:
    """``gs_fused.cu`` with the edits of ``EDITS[name]``; prints what
    ptxas says of B10 at P = 1."""
    with open(os.path.join(cuda_build.CSRC, "gs_fused.cu")) as fh:
        src = fh.read()
    for old, new in EDITS[name]:
        if old not in src:
            raise RuntimeError(f"gs_fused.cu changed: {old!r} not found")
        src = src.replace(old, new)
    out = os.path.join(cuda_build.BUILD_DIR, "exp_fused_integrate")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"v{list(EDITS).index(name)}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    log = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC,
         "-o", path[:-3] + ".so", path], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    lines = (log.stdout + log.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and "fused_kernelILi1ELb0E" in line:
            print(f"{name}: ptxas, B10 at P = 1: {lines[i + 1].strip()}; "
                  f"{lines[i + 2].split(': ')[-1].strip()}")
    return ctypes.CDLL(path[:-3] + ".so")


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_fused_integrate_step: needs a CUDA device",
              file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line())
    built = cuda_build.load("gs_fused")
    libs = {name: _build(name) for name in EDITS}
    carrying = solver.fused_sweep

    def standalone(*args, integrate=None, **kw):
        pose, com, dt = integrate
        new = gs_fused.fused_integrate(pose, args[0], com, dt)
        return carrying(*args, **kw) + (new,)

    plans = {"carried": (carrying, built),
             "standalone": (standalone, built),
             "no integrate in B10": (standalone, libs["no integrate in B10"]),
             "carried, __sinf / __cosf": (
                 carrying, libs["carried, __sinf / __cosf"])}
    z = dict(np.load(cs.NPZ))
    cfg = PipelineConfig.from_dict(json.loads(str(np.load(cs.NPZ_FUSED)[
        "config_json"])))
    params = SimParams()
    state = state_from_arrays(z, device="cuda")
    for _ in range(cs.WARM_FRAMES):
        state, cfg = step_checked(state, params, cfg)
    torch.cuda.synchronize()
    b10 = {name: [] for name in plans}
    dev = {name: [] for name in plans}
    try:
        for r in range(WINDOWS):
            for name in (list(plans) if r % 2 == 0 else list(plans)[::-1]):
                solver.fused_sweep, cuda_build._LIBS["gs_fused"] = plans[name]
                prof = cs.profile_window(cs._pit_stepper(state, cfg, params),
                                         frames=4)
                row = next(t for t in prof["top"]
                           if "fused_kernel<1, false>" in t["name"])
                b10[name].append(1e3 * row["ms_per_step"]
                                 / row["calls_per_step"])
                dev[name].append(prof["device_ms_per_step"])
                print(f"{name}: B10 in the step {b10[name][-1]:.2f} us a "
                      f"launch, device {dev[name][-1]:.4f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step")
    finally:
        solver.fused_sweep, cuda_build._LIBS["gs_fused"] = carrying, built
    for name in plans:
        print(f"{name}: medians over {WINDOWS} windows: B10 in the step "
              f"{statistics.median(b10[name]):.2f} us a launch, device "
              f"{statistics.median(dev[name]):.4f} ms/step")
    call = next(c for c in cs.pit_fused_calls("cuda")
                if c.name == "fused_sweep")
    bare = type(call)(name=call.name, args=call.args, kw={
        k: v for k, v in call.kw.items() if k != "integrate"})
    with_ms, without_ms = cs.paired_ms(lambda: cs.run_fused(call, "kernel"),
                                       lambda: cs.run_fused(bare, "kernel"))
    print(f"the pit's first B10 alone: carrying B12 {with_ms * 1e3:.2f} us, "
          f"without {without_ms * 1e3:.2f} us (in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
