"""Per-phase timing and run statistics (counterpart of
``wgmath_tpu/core/profiling.py``).

``RunStats`` accumulates per-phase milliseconds and counters (the same
keys and ``summary()`` as the JAX package's). ``PhaseTimer`` times a
labelled phase on the host's clock after synchronising the device of the
tensors it is handed (the JAX package blocks on its arrays). ``trace``
records a ``torch.profiler`` trace and writes it as a Chrome trace;
``timeit`` gives the median time of a call, by CUDA events where the call
works on the card and by the host's clock otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any

import torch


@dataclasses.dataclass
class RunStats:
    """Accumulated per-phase timings (ms) and counters for one run."""

    phase_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    counters: dict[str, int] = dataclasses.field(default_factory=dict)

    def add_phase(self, name: str, ms: float) -> None:
        self.phase_ms[name] = self.phase_ms.get(name, 0.0) + ms

    def bump(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def total_ms(self) -> float:
        return sum(self.phase_ms.values())

    def summary(self) -> str:
        lines = [f"total: {self.total_ms():8.3f} ms"]
        for name, ms in sorted(self.phase_ms.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<28s} {ms:8.3f} ms")
        for name, n in sorted(self.counters.items()):
            lines.append(f"  {name:<28s} {n}")
        return "\n".join(lines)


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (tensors, sequences,
    dicts and dataclasses, walked)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            found.add(obj.device)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _cuda_devices(x, found)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    return found


def sync(obj) -> None:
    """Wait for the devices of the CUDA tensors in ``obj``."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Labelled phase timer; synchronises the device of the held tensors
    before it reads the clock, so the time covers their work.

    Usage::

        stats = RunStats()
        timer = PhaseTimer(stats)
        with timer.phase("step") as h:
            state = step(...)
            h.append(state.bodies.poses.translation)
    """

    def __init__(self, stats: RunStats):
        self.stats = stats

    @contextlib.contextmanager
    def phase(self, name: str, result: Any = None):
        start = time.perf_counter()
        holder: list[Any] = []
        try:
            yield holder
        finally:
            sync(holder[0] if holder else result)
            self.stats.add_phase(name, (time.perf_counter() - start) * 1e3)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the card's kernels too,
    where there is one), written to ``log_dir/trace.json`` as a Chrome
    trace; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timeit(fn, *args, iters: int = 10, warmup: int = 3) -> float:
    """Median seconds per call of ``fn(*args)``: between CUDA events where
    the arguments or the result hold CUDA tensors, else on the host's
    clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    devs = _cuda_devices((args, out), set())
    times = []
    if devs:
        dev = next(iter(devs))
        sync(out)
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(dev):
                a.record()
                fn(*args)
                b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
