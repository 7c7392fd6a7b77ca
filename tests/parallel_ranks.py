"""Rank bodies for the sharded steps, started with ``torch.multiprocessing``
(the spawn start method), shared by ``tests/test_torch_parallel.py`` (gloo
ranks on the CPU) and ``chip_smoke.py`` (NCCL at world size 1, gloo at
world size 2 with both ranks on one card). Imports neither JAX nor the
JAX package.

:func:`run_ranks` starts ``world`` processes, each of which joins a
``torch.distributed`` group over ``tcp://127.0.0.1:<free port>``, sets one
PyTorch thread, runs a list of jobs of :data:`JOBS` one after another in
that group and writes their results with ``torch.save``; the results come
back by rank, then job. A rank that fails makes :func:`run_ranks` raise
with its traceback.

Jobs:

- ``"pipeline"``: ``frames`` frames of ``parallel.sharded_pipeline``
  (``step`` under a fixed configuration, as the JAX package's
  ``make_sharded_step``) from a state as ``convert.state_to_arrays`` lays
  it out, with each frame's translations, pair counts, broad-phase cache
  pairs and a SHA-1 of the whole state; then ``timed`` further frames
  timed, with the collectives, their bytes, the B2 launches and the host
  syncs a frame. With ``record_b2``, the inputs and outputs of every B2
  one-rung launch of the first frame's first sweep on this rank (on the
  CPU; ``solver.gs_math_block`` as ``solver._sweep_torch`` calls it) and
  the rows of that sweep's occupied rungs.
- ``"round1"``: one frame of ``parallel.sharded`` from such a state.
- ``"refuse"``: the errors a bad shard raises (a ``pair_capacity`` that
  is not a multiple of the rank count, a rank count that is not the
  group's).
"""

from __future__ import annotations

import hashlib
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_digest(arrays: dict) -> str:
    """SHA-1 over every array's name, dtype, shape and bytes."""
    h = hashlib.sha1()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cpu(x):
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(y) for y in x)
    if hasattr(x, "__dict__"):
        return {k: _cpu(v) for k, v in vars(x).items()}
    return x


def _record_first_sweep_b2(run):
    """``run()``, recording each B2 one-rung launch of its first sweep as
    ``(args, kwargs, outputs)`` on the CPU (a namespace argument as a
    dict), and the rows of the sweep's occupied rungs."""
    from wgmath_tpu_torch.dynamics import solver

    calls, rungs = [], []
    real_sweep, real_b2 = solver.run_sweep, solver.gs_math_block

    def b2(*args, **kw):
        out = real_b2(*args, **kw)
        calls.append(_cpu((args, kw, out)))
        return out

    def first_sweep(plan, *args, **kw):
        solver.run_sweep = real_sweep
        rungs.extend(r.rows for r in plan.rungs if r.rows)
        solver.gs_math_block = b2
        try:
            real_sweep(plan, *args, **kw)
        finally:
            solver.gs_math_block = real_b2

    solver.run_sweep = first_sweep
    try:
        out = run()
    finally:
        solver.run_sweep, solver.gs_math_block = real_sweep, real_b2
    return out, calls, rungs


def _pipeline_job(rank: int, world: int, *, arrays, params, config, frames,
                  timed=0, record_b2=False, device="cpu"):
    from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
    from wgmath_tpu_torch.core import collectives, dispatch
    from wgmath_tpu_torch.dynamics import gs_math
    from wgmath_tpu_torch.parallel.sharded_pipeline import (
        make_sharded_step,
        replicate_state,
    )

    state = replicate_state(state_from_arrays(arrays, device))
    run = make_sharded_step(None, params, config)
    out = {"translation": [], "pair_count": [], "bp_pairs": [],
           "digest": []}
    for f in range(frames):
        if record_b2 and f == 0:
            state, out["b2_calls"], out["b2_rungs"] = \
                _record_first_sweep_b2(lambda: run(state))
        else:
            state = run(state)
        a = state_to_arrays(state)
        out["translation"].append(a["bodies.poses.translation"])
        out["pair_count"].append(a["pair_count"])
        out["bp_pairs"].append(
            None if "bp_pairs.body_a" not in a else
            np.stack([a["bp_pairs.body_a"], a["bp_pairs.body_b"],
                      a["bp_pairs.valid"].astype(np.int32)]))
        out["digest"].append(state_digest(a))
    if timed:
        run(state)  # one untimed frame
        _sync(device)
        c0, b0 = collectives.COLLECTIVES, collectives.BYTES
        l0, h0 = gs_math.LAUNCHES_BLOCK, dispatch.HOST_SYNCS
        t0 = time.perf_counter()
        for _ in range(timed):
            state = run(state)
        _sync(device)
        dt = time.perf_counter() - t0
        out["timed"] = {
            "frames": timed, "ms_per_step": dt * 1e3 / timed,
            "collectives_per_step":
                (collectives.COLLECTIVES - c0) / timed,
            "bytes_per_step": (collectives.BYTES - b0) / timed,
            "b2_launches_per_step": (gs_math.LAUNCHES_BLOCK - l0) / timed,
            "host_syncs_per_step": (dispatch.HOST_SYNCS - h0) / timed,
            "digest": state_digest(state_to_arrays(state))}
    return out


def _round1_job(rank: int, world: int, *, arrays, params, config,
                device="cpu"):
    from wgmath_tpu_torch.convert import state_from_arrays
    from wgmath_tpu_torch.parallel import (
        body_mesh,
        make_sharded_step,
        shard_state,
    )

    state = state_from_arrays(arrays, device)
    mesh = body_mesh(world)
    bodies, shapes = shard_state(state, mesh)
    _sync(device)
    t0 = time.perf_counter()
    local, count = make_sharded_step(mesh, params, config)(bodies, shapes)
    _sync(device)
    return {"translation": local.poses.translation.cpu().numpy(),
            "linear": local.vels.linear.cpu().numpy(),
            "pair_count": int(count),
            "ms": (time.perf_counter() - t0) * 1e3}


def _refuse_job(rank: int, world: int, *, arrays, params, config,
                device="cpu"):
    import dataclasses

    from wgmath_tpu_torch.convert import state_from_arrays
    from wgmath_tpu_torch.parallel.sharded_pipeline import make_sharded_step
    from wgmath_tpu_torch.pipeline import step

    state = state_from_arrays(arrays, device)
    odd = dataclasses.replace(config,
                              pair_capacity=config.pair_capacity + 1)
    errors = {}
    for name, call in (
            ("make_sharded_step", lambda: make_sharded_step(None, params,
                                                            odd)),
            ("step", lambda: step(state, params, odd, shard=(None, world))),
            ("ranks", lambda: step(state, params, config,
                                   shard=(None, world + 1)))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    return errors


JOBS = {"pipeline": _pipeline_job, "round1": _round1_job,
        "refuse": _refuse_job}


def _rank_main(rank: int, world: int, backend: str, port: int,
               in_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        jobs, device = torch.load(in_path, weights_only=False)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=world, rank=rank)
        try:
            res = [JOBS[job](rank, world, device=device, **kw)
                   for job, kw in jobs]
        finally:
            dist.destroy_process_group()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(jobs: list, world: int, backend: str = "gloo",
              device="cpu") -> list:
    """Run ``jobs``, a list of (job name, keyword arguments), one after
    another on ``world`` spawned ranks of a ``backend`` group, each rank's
    tensors on ``device``. Returns ``results[rank][job]``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.pt")
        torch.save((list(jobs), str(device)), in_path)
        try:
            mp.start_processes(
                _rank_main, args=(world, backend, free_port(), in_path, tmp),
                nprocs=world, join=True, start_method="spawn")
        except Exception as e:
            errs = [open(os.path.join(tmp, f)).read()
                    for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            raise RuntimeError(f"{world} {backend} ranks failed: "
                               + ("\n".join(errs) or str(e))) from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
