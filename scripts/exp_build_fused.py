"""Where does kernel B9's time go? (``csrc/build_fused.cu``)

Builds copies of the kernel cut off at each stage and times them beside
the kernel as built, on ``chip_smoke.fused_kernel_phase``'s seeded inputs
at the fused pit's shapes (C = 30,080 constraints, P = 1, 10,005 bodies):

- ``launch only``: the grid, each thread storing one zero;
- ``gathers``: both ids, the contact fields and both 128-byte body rows
  loaded, one sum stored a thread;
- ``no field stores``: all the arithmetic, every field summed into one
  store a thread in place of its 71;
- ``blocks of 64`` / ``blocks of 256``: the kernel as built with the
  launch plan's block size forced (as built it chooses 128 there).

Beside them, two yardsticks: the standalone B12 (``fused_integrate``, 1 MB
at Wg = 10,112 lanes: the cost of one small launch) and ``zero_()`` of a
tensor of bigT's size (8.5 MB written by a library kernel). Each timing is
the median over 4 rounds of 25 launches behind a busy-wait
(``chip_smoke.device_times_ms``), the variants in alternating order. Every
variant that computes bigT is checked equal to ``build_fused._launch``.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_build_fused.py
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
from wgmath_tpu_torch.core import cuda_build  # noqa: E402
from wgmath_tpu_torch.dynamics import build_fused, gs_fused  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "exp_build_fused")
ROUNDS = 4


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"build_fused.cu changed: {old[:60]!r} not found")
    return src.replace(old, new)


def variants() -> dict:
    """Name → (source, whether it computes bigT)."""
    with open(os.path.join(cuda_build.CSRC, "build_fused.cu")) as fh:
        src = fh.read()
    top = "  if (i >= C) return;\n"
    loaded = "  const Body A = unpack(ra), B = unpack(rb);\n"
    acc = _edit(src, "  const Rows& rows;\n  __device__ __forceinline__ void "
                "put(int field, int e, float v) const {\n    out[(size_t)"
                "(rows.r[field] + e) * c + i] = v;\n  }",
                "  const Rows& rows;\n  float* acc;\n  __device__ "
                "__forceinline__ void put(int field, int e, float v) const "
                "{\n    *acc += v;\n  }")
    acc = _edit(acc, "  const Writer wr{big, C, i, rows};",
                "  float sum = 0.0f;\n  const Writer wr{big, C, i, rows, "
                "&sum};")
    acc = _edit(acc, "lb.z / sc2});\n  }\n}", "lb.z / sc2});\n  }\n  "
                "big[i] = sum;\n}")
    blocks = "constexpr int BLOCKS[3] = {256, 128, 64};"
    return {
        "as built": (src, True),
        "launch only": (_edit(src, top, top + "  big[i] = 0.0f;\n  if (C > 0)"
                              " return;\n"), False),
        "gathers": (_edit(src, loaded, loaded + "  big[i] = A.w + B.w + "
                          "A.com.z + B.com.z + n.x + dists[0] + pts[0].z;\n"
                          "  if (C > 0) return;\n"), False),
        "no field stores": (acc, False),
        "blocks of 64": (_edit(src, blocks, "constexpr int BLOCKS[3] = "
                               "{64, 64, 64};"), True),
        "blocks of 256": (_edit(src, blocks, "constexpr int BLOCKS[3] = "
                                "{256, 256, 256};"), True),
    }


def build(vs: dict) -> dict:
    """Each variant compiled as ``build_fused.cu`` is (one nvcc each, all
    together); prints ptxas's register lines. Returns name → library."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k, (name, (src, _)) in enumerate(vs.items()):
        path = os.path.join(OUT, f"v{k}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split(": ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print(f"{name}: ptxas (P = 4, P = 1): {'; '.join(regs)}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_build_fused: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line())
    vs = variants()
    libs = build(vs)
    zf = np.load(cs.NPZ_FUSED)
    cfg = json.loads(str(zf["config_json"]))
    counts = [int(x) for x in
              zf["ref.0.pair_count"][8:8 + cfg["max_colors"] + 2]]
    rng = np.random.default_rng(20265)
    z = cs.fused_inputs(rng, 10_005, tuple(cfg["gs_windows"][
        :cfg["max_colors"]]), cfg["gs_rung0"], counts, 1, "cuda")
    packed, contacts, consts, meta, k_all, p = cs.b9_args(z)
    c = contacts.capacity
    print(f"C={c} P={p} bodies {packed.shape[0]}; launch plan (block, "
          f"registers, warps an SM holds): {build_fused.plan(p, c)}")
    rows = (ctypes.c_int * len(build_fused.F32_SORT_FIELDS))(
        *[int(meta[f][0]) for f in build_fused.F32_SORT_FIELDS])
    want = build_fused._launch(packed, contacts, consts, meta, k_all, p)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, out):
        fn = lib.build_fused_launch
        fn.argtypes = build_fused._ARGTYPES
        fn.restype = ctypes.c_int
        args = (p, c, packed.data_ptr(), contacts.body_a.data_ptr(),
                contacts.body_b.data_ptr(), contacts.normal_a.data_ptr(),
                contacts.normal_a.stride(0), contacts.points_a.data_ptr(),
                contacts.points_a.stride(0), contacts.dist.data_ptr(),
                contacts.dist.stride(0), *[float(x) for x in consts], rows,
                out.data_ptr(), stream)

        def run():
            err = fn(*args)
            if err:
                raise RuntimeError(f"launch failed: error {err}")
        return run

    fns = {}
    for name, lib in libs.items():
        out = torch.empty_like(want)
        fns[name] = launcher(lib, out)
        fns[name]()
        torch.cuda.synchronize()
        if vs[name][1] and not torch.equal(out, want):
            raise RuntimeError(f"{name}: bigT differs from the kernel's")
    w_g = gs_fused.gather_width(10_005, tuple(cfg["gs_windows"][
        :cfg["max_colors"]]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    pose, vt, com = (torch.randn((r, w_g), device="cuda", generator=gen)
                     for r in (8, 8, 3))
    fns["B12 standalone (yardstick)"] = lambda: gs_fused._launch_integrate(
        pose, vt, com, 1.0 / 240.0)
    zero = torch.empty_like(want)
    fns["zero_ of bigT's size (yardstick)"] = zero.zero_
    times = {name: [] for name in fns}
    for r in range(ROUNDS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name] += cs.device_times_ms(fns[name])
    for name, t in times.items():
        q1, q3 = np.percentile(t, [25, 75])
        print(f"{name:34s} median {statistics.median(t) * 1e3:7.2f} us "
              f"(quartiles {q1 * 1e3:.2f} / {q3 * 1e3:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
