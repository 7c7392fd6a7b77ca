"""Where does kernel B7's time go? (``csrc/reduce.cu``)

Builds variants of the reduction and times them at the graph path's length
(4,194,304 f32, ``chip_smoke.REDUCE_N``; sqnorm, sum, min) and at
1,000,003 (sum, min), with the input warm in L2 (as the
graph path reads it, just written by the product) and with L2 flushed before
each launch by ``chip_smoke.L2_FLUSH_BYTES`` either written by a library
fill (L2 left full of dirty lines, which the reads must evict) or read by a
library reduction (L2 left full of clean lines):

- ``as built``: one launch, float4 loads unrolled by 4 into independent
  registers, the last ticket's block folding the partials;
- ``unroll 8``: the same with 8 loads in flight a thread;
- ``one block an SM``: the grid capped at one block an SM (132, not 264);
- ``blocks of 256, 4 an SM``: the same threads an SM in twice the blocks;
- ``blocks of 1024, 1 an SM``: the same threads an SM in half the blocks,
  so half the partials and tickets;
- ``TMA ring``: the body read by 1-D ``cp.async.bulk`` copies of 8 KB
  (one ``float4`` a thread) into a ring of 4 stages in shared memory,
  completion counted on ``mbarrier``s, one thread issuing, the block
  folding each stage in place of the loads (the same groups in the same
  order, so the same bits);
- ``fenced ticket``: a plain ``atomicAdd`` between two ``__threadfence``
  in place of the acquire-release atomic add;
- ``slot accumulators``: one accumulator for each of the UNROLL load
  slots, folded into one at the end (shorter chains of dependent folds;
  another order, other bits);
- ``partials only``: as built, cut off after each block's partial is
  stored (no ticket, no last block's fold; computes no scalar, unchecked);
- ``parent`` (with ``--parent PATH``): the ``reduce.cu`` of an earlier
  tree, two launches a call (``reduce_partials`` and ``reduce_final``).

Beside them: an empty kernel on the same grid (the harness's one-launch
floor) and the library calls ``torch.dot(x, x)`` and ``torch.sum``. Each
timing is the median over 4 rounds of 25 launches behind a busy-wait
(``chip_smoke.device_times_ms``), the variants in alternating order. Every
variant's result is checked: the same bits as ``as built`` where it keeps
its grid, the plain version within ``chip_smoke.REDUCE_TOL`` otherwise.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_reduce.py [--parent path/to/old/reduce.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from wgmath_tpu_torch.core import cuda_build  # noqa: E402

reduce_ops = cs.reduce_ops
OUT = os.path.join(cuda_build.BUILD_DIR, "exp_reduce")
ROUNDS = 4
# (length, op) timed; the library call of each op beside it
CASES = ((cs.REDUCE_N, "sqnorm"), (cs.REDUCE_N, "sum"), (cs.REDUCE_N, "min"),
         (1_000_003, "sum"), (1_000_003, "min"))
LIBRARY = {"sqnorm": ("torch.dot(x, x)", lambda x: torch.dot(x, x)),
           "sum": ("torch.sum", torch.sum), "min": ("torch.amin", torch.amin)}
# variants that fold in another order than as built (other bits)
ORDER_CHANGES = ("one block an SM", "blocks of 256, 4 an SM",
                 "blocks of 1024, 1 an SM", "slot accumulators", "parent")

TMA_FOLD = r'''
constexpr int STAGES = 4;

// The block's full groups [lo, min(hi, n / 4)) by 1-D bulk copies of
// THREADS groups into a ring of STAGES stages; thread t folds group
// lo + c THREADS + t of chunk c, the short last group by scalar loads.
template <int OP>
__device__ float tma_fold(const float* __restrict__ x, long long n,
                          long long lo, long long hi) {
  __shared__ alignas(128) float4 ring[STAGES][THREADS];
  __shared__ alignas(8) uint64_t full[STAGES];
  const long long f_hi = hi < n / 4 ? hi : n / 4;
  const int chunks = (int)((hi - lo + THREADS - 1) / THREADS);
  const int tma_chunks =
      f_hi > lo ? (int)((f_hi - lo + THREADS - 1) / THREADS) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int c) {
    const long long g0 = lo + (long long)c * THREADS;
    const long long g1 = g0 + THREADS < f_hi ? g0 + THREADS : f_hi;
    const uint32_t bytes = (uint32_t)(g1 - g0) * 16u;
    uint64_t* bar = &full[c % STAGES];
    hopper::mbar_expect_tx(bar, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :
        : "r"(hopper::smem_u32(ring[c % STAGES])),
          "l"(reinterpret_cast<const float4*>(x) + g0), "r"(bytes),
          "r"(hopper::smem_u32(bar))
        : "memory");
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < STAGES && c < tma_chunks; ++c) issue(c);
  float acc = identity<OP>();
  for (int c = 0; c < chunks; ++c) {
    const long long g = lo + (long long)c * THREADS + threadIdx.x;
    if (c < tma_chunks) {
      hopper::mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
      if (g < f_hi)
        acc = fold4<OP>(acc, ring[c % STAGES][threadIdx.x]);
      else if (g < hi)
        acc = fold4<OP>(acc, load_group<OP, false>(x, n, g));
      // every thread is done with the stage before the copy refills it
      hopper::fence_proxy_async();
      __syncthreads();
      if (threadIdx.x == 0 && c + STAGES < tma_chunks) issue(c + STAGES);
    } else if (g < hi) {
      acc = fold4<OP>(acc, load_group<OP, false>(x, n, g));
    }
  }
  return acc;
}

'''


ACQ_REL_TICKET = r'''    unsigned t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(ticket)
                 : "memory");
'''
FENCED_TICKET = """    __threadfence();
    const unsigned t = atomicAdd(ticket, 1u);
"""
WARP0 = "  if (!last || threadIdx.x >= 32) return;\n"


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"reduce.cu changed: {old[:60]!r} not found")
    return src.replace(old, new)


def variants(parent: str | None) -> dict:
    """Name -> source."""
    with open(os.path.join(cuda_build.CSRC, "reduce.cu")) as fh:
        src = fh.read()
    tma = _edit(src, "#include <cstdint>\n",
                "#include <cstdint>\n\n#include \"wgmma.cuh\"\n")
    tma = _edit(tma, "// `partial`: one f32 a block",
                TMA_FOLD + "// `partial`: one f32 a block")
    tma = _edit(tma, "  float acc = identity<OP>();\n  for (long long base",
                "  float acc = identity<OP>();\n  if (ALIGNED) acc = "
                "tma_fold<OP>(x, n, lo, hi);\n  else\n  for (long long base")
    out = {
        "as built": src,
        "unroll 8": _edit(src, "constexpr int UNROLL = 4;",
                          "constexpr int UNROLL = 8;"),
        "one block an SM": _edit(src, "constexpr int BLOCKS_PER_SM = 2;",
                                 "constexpr int BLOCKS_PER_SM = 1;"),
        "blocks of 256, 4 an SM": _edit(_edit(
            src, "constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
            "constexpr int BLOCKS_PER_SM = 2;",
            "constexpr int BLOCKS_PER_SM = 4;"),
        "blocks of 1024, 1 an SM": _edit(_edit(
            src, "constexpr int THREADS = 512;",
            "constexpr int THREADS = 1024;"),
            "constexpr int BLOCKS_PER_SM = 2;",
            "constexpr int BLOCKS_PER_SM = 1;"),
        "TMA ring": tma,
        "TMA ring, 2 stages": _edit(tma, "constexpr int STAGES = 4;",
                                    "constexpr int STAGES = 2;"),
        "fenced ticket": _edit(_edit(src, ACQ_REL_TICKET, FENCED_TICKET),
                               WARP0, WARP0 + "  __threadfence();\n"),
        "slot accumulators": _edit(_edit(
            src, "  float acc = identity<OP>();\n  for (long long base",
            "  float slot[UNROLL];\n#pragma unroll\n  for (int k = 0; k < "
            "UNROLL; ++k) slot[k] = identity<OP>();\n  for (long long base"),
            "    for (int k = 0; k < UNROLL; ++k) acc = fold4<OP>(acc, v[k]);"
            "\n  }\n",
            "    for (int k = 0; k < UNROLL; ++k) slot[k] = fold4<OP>(slot[k], "
            "v[k]);\n  }\n  float acc = slot[0];\n#pragma unroll\n  for "
            "(int k = 1; k < UNROLL; ++k) acc = combine<OP>(acc, slot[k]);\n"),
        "partials only": _edit(src, "  __shared__ bool last;\n",
                               "  if (threadIdx.x == 0) partial[blockIdx.x] "
                               "= acc;\n  if (n > 0) return;\n"
                               "  __shared__ bool last;\n"),
    }
    if parent:
        with open(parent) as fh:
            out["parent"] = fh.read()
    return out


def build(vs: dict) -> dict:
    """Each variant compiled as ``reduce.cu`` is (one nvcc each, all
    together); prints ptxas's register lines. Returns name -> library."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k, (name, src) in enumerate(vs.items()):
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
        use = sorted({ln.split(": ")[-1] for ln in log.splitlines()
                      if "registers" in ln})
        print(f"{name}: ptxas: {'; '.join(use)}")
        libs[name] = ctypes.CDLL(so)
    return libs


def launcher(name: str, lib, x: torch.Tensor, op: str):
    """(call, grid) for one variant: ``call()`` reduces x into a fresh
    scalar on the current stream."""
    n, code = x.numel(), reduce_ops._OP_CODE[op]
    stream = torch.cuda.current_stream().cuda_stream
    if name == "parent":
        lib.reduce_blocks.argtypes = [ctypes.c_longlong]
        lib.reduce_blocks.restype = ctypes.c_int
        fn = lib.reduce_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        blocks = lib.reduce_blocks(n)
        partial = torch.empty(blocks, dtype=torch.float32, device="cuda")

        def call():
            out = torch.empty((), dtype=torch.float32, device="cuda")
            err = fn(code, x.data_ptr(), n, partial.data_ptr(),
                     out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: launch failed: error {err}")
            return out
        return call, blocks
    lib.reduce_max_blocks.restype = ctypes.c_int
    fn = lib.reduce_launch
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    blocks = reduce_ops.grid(n, lib.reduce_max_blocks())
    # the partials, then the ticket; the closure keeps the tensor alive
    scratch = torch.zeros(blocks + 1, dtype=torch.float32, device="cuda")

    def call():
        out = torch.empty((), dtype=torch.float32, device="cuda")
        partial = scratch.data_ptr()
        err = fn(code, x.data_ptr(), n, blocks, partial, partial + 4 * blocks,
                 out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{name}: launch failed: error {err}")
        return out
    return call, blocks


def _tol(op, x, want) -> float:
    """The smoke test's limit for the kernel against the plain version."""
    pre = reduce_ops._OPS[op][0]
    scale = (abs(float(want)) if op in ("prod", "min", "max")
             else float(pre(x).abs().sum()))
    return cs.REDUCE_TOL[op] * scale


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_reduce: needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="reduce.cu of an earlier tree")
    args = ap.parse_args()
    print(cs.nvidia_smi_line())
    libs = build(variants(args.parent))
    rng = np.random.default_rng(20263)
    xs = {n: cs._cuda(rng.uniform(0.999, 1.001, size=n)
                      * rng.choice([-1.0, 1.0], size=n))
          for n in sorted({n for n, _ in CASES})}
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    wrong = []
    for n, op in CASES:
        x = xs[n]
        b_ms = cs.bound_ms(4 * n + 4, (2 if op == "sqnorm" else 1) * n)[0]
        print(f"n={n} {op}: bound {b_ms * 1e3:.2f} us (bytes at 3.35 TB/s)")
        want = reduce_ops._reduce_torch(x, op)
        tol = _tol(op, x, want)
        calls, grids = {}, {}
        for name, lib in libs.items():
            calls[name], grids[name] = launcher(name, lib, x, op)
        ref = calls["as built"]()
        for name, call in calls.items():
            if name == "partials only":
                continue
            got = call()
            repeats = [call() for _ in range(10)]
            torch.cuda.synchronize()
            varies = sum(not torch.equal(r, got) for r in repeats)
            if varies:
                print(f"{n} {op} {name}: {varies} of 10 repeats gave other "
                      "bits")
            same = bool(torch.equal(got, ref))
            err = abs(float(got) - float(want))
            if name not in ORDER_CHANGES:
                ok = same
            else:
                ok = err <= tol
            print(f"{n} {op} {name}: grid {grids[name]}, |d| to plain "
                  f"{err:.3e} (limit {tol:.3e}), bits of as built: {same}")
            if not ok:
                print(f"{n} {op} {name}: WRONG RESULT (timed all the same)")
                wrong.append((n, op, name))
        lib = libs["as built"]
        empty = lib.reduce_empty_launch
        empty.argtypes = [ctypes.c_void_p] * 2
        empty.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        timed = dict(calls)
        timed["as built, through reduce()"] = lambda: reduce_ops.reduce(x, op)
        timed["empty kernel, same grid"] = lambda: empty(
            grids["as built"], stream)
        lib_name, lib_fn = LIBRARY[op]
        timed["library " + lib_name] = lambda: lib_fn(x)
        flushes = {"warm": None, "written": flush.zero_,
                   "read": lambda: flush.amax()}
        times = {(k, f): [] for k in timed for f in flushes}
        names = list(timed)
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                for f, before in flushes.items():
                    times[name, f] += cs.device_times_ms(timed[name],
                                                         before=before)
        for name in names:
            w, c, d = (statistics.median(times[name, f]) * 1e3
                       for f in flushes)
            print(f"{n} {op} {name}: L2 warm {w:.2f} us, L2 flushed by a write "
                  f"{c:.2f} us, by a read {d:.2f} us")
    if wrong:
        print(f"wrong results: {wrong}")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
