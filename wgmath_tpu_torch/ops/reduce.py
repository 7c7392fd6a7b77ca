"""Vector reductions (counterpart of ``wgmath_tpu/ops/reduce.py``, the
reference's ``Reduce``): min / max / sum / prod / sqnorm of an array to one
scalar.

On a CUDA tensor of float32, :func:`reduce` launches the hand-written kernel
``csrc/reduce.cu`` (one launch a call, no float atomics, bitwise
repeatable), which replaces the TPU kernel ``_reduce_pallas``. Any length
>= 1 is taken; the array is reduced through its flattened contiguous form.
The result stays on the device: no host sync. On a CPU tensor, and for
other types, it runs the plain version :func:`_reduce_torch`. ``eval_cpu``
is the NumPy oracle.

:func:`reduce_plan` and :func:`_reduce_emulated` write out on the CPU how
the kernel cuts a call over its grid and in what order it folds the
elements, so that the tests can hold that order without a card.

min and max return NaN when any element is NaN, in the kernel and in the
plain version alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from wgmath_tpu_torch.core import cuda_build
from wgmath_tpu_torch.core.dispatch import as_tensor, check_kernel_operand
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)

# op name -> (elementwise pre-map, full reduction, identity); the order of
# the names is the kernel's op code
_OPS = {
    "sum": (lambda x: x, torch.sum, 0.0),
    "prod": (lambda x: x, torch.prod, 1.0),
    "min": (lambda x: x, torch.amin, np.inf),
    "max": (lambda x: x, torch.amax, -np.inf),
    "sqnorm": (lambda x: x * x, torch.sum, 0.0),
}
_OP_CODE = {name: i for i, name in enumerate(_OPS)}
IMPLS = ("auto", "cuda", "torch")

# csrc/reduce.cu's block size and loads in flight a thread
THREADS, UNROLL = 512, 4
# the least share of a block: shorter calls take fewer blocks, and one of
# at most MIN_SHARE elements writes its scalar without a ticket
MIN_SHARE = 8192

LAUNCHES_REDUCE = 0


def _reduce_torch(x: torch.Tensor, op: str) -> torch.Tensor:
    """Plain version: the pre-map, then one full reduction (an empty array
    gives the identity)."""
    pre, full, ident = _OPS[op]
    if x.numel() == 0:
        return torch.full((), ident, dtype=x.dtype, device=x.device)
    return full(pre(x))


# --- the kernel's plan, written out on the CPU --------------------------------


def grid(n: int, max_blocks: int) -> int:
    """Blocks of the launch for ``n`` elements on a card that takes
    ``max_blocks`` (:func:`max_blocks`)."""
    return max(1, min(max_blocks, -(-n // MIN_SHARE)))


class BlockShare(NamedTuple):
    """One block's share of a call, as ranges ``(start, stop)``: ``groups``
    of 4 elements, the ``elements`` they hold, the groups read by ``float4``
    loads and the elements read by scalar loads."""
    groups: tuple
    elements: tuple
    float4: tuple
    scalars: tuple


def reduce_plan(n: int, blocks: int, aligned: bool) -> list[BlockShare]:
    """How the kernel cuts ``n`` elements over ``blocks`` blocks. x is read
    in groups of 4 elements; each block takes a contiguous, even share of
    the groups. Where x starts on a 16-byte boundary (``aligned``) a full
    group is one ``float4`` load and the short last group (``n % 4``
    elements) takes scalar loads; otherwise every group takes scalar
    loads. The order of the folds does not depend on ``aligned``."""
    groups, full = -(-n // 4), n // 4 if aligned else 0
    out = []
    for b in range(blocks):
        lo, hi = groups * b // blocks, groups * (b + 1) // blocks
        v_hi = min(hi, full)
        out.append(BlockShare((lo, hi), (4 * lo, min(4 * hi, n)),
                              (lo, max(lo, v_hi)),
                              (4 * max(lo, v_hi), min(4 * hi, n))))
    return out


def fold_order(n: int, blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, active): ``index[b, t, r, s]`` is the element that thread
    ``t`` of block ``b`` folds at step ``s`` of its round ``r`` (-1: the
    identity, a slot past the share or past n), steps in the order of
    ``csrc/reduce.cu``: slot k's group, then its x, y, z, w. ``active[b, t,
    r]``: the thread runs round ``r`` (its first slot lies in its share)."""
    plan = reduce_plan(n, blocks, True)
    lo = torch.tensor([p.groups[0] for p in plan]).view(-1, 1, 1, 1)
    hi = torch.tensor([p.groups[1] for p in plan]).view(-1, 1, 1, 1)
    rounds = max(1, -(-int((hi - lo).max()) // (UNROLL * THREADS)))
    t = torch.arange(THREADS).view(1, -1, 1, 1)
    r = torch.arange(rounds).view(1, 1, -1, 1)
    k = torch.arange(UNROLL).view(1, 1, 1, -1)
    g = lo + t + THREADS * (k + UNROLL * r)  # [blocks, THREADS, rounds, k]
    active = g[..., 0] < hi[..., 0]
    e = 4 * g.unsqueeze(-1) + torch.arange(4)
    keep = (g < hi).unsqueeze(-1) & (e < n)
    index = torch.where(keep, e, -1).flatten(3)
    return index, active


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's ``combine``, elementwise in f32."""
    if op == "prod":
        return a * b
    if op == "min":
        return torch.where((a < b) | torch.isnan(a), a, b)
    if op == "max":
        return torch.where((a > b) | torch.isnan(a), a, b)
    return a + b


def _warp_fold(op: str, v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_fold`` of ``v`` [..., 32]: shuffles down 16, 8,
    4, 2, 1; lane 0's value."""
    for d in (16, 8, 4, 2, 1):
        v = _combine(op, v[..., :d], v[..., d:2 * d])
    return v[..., 0]


def _block_fold(op: str, v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``block_fold`` of ``v`` [..., THREADS]: each warp's
    ``warp_fold``, then shuffles over the warps' values."""
    v = _warp_fold(op, v.unflatten(-1, (THREADS // 32, 32)))
    d = THREADS // 64
    while d:
        v = _combine(op, v[..., :d], v[..., d:2 * d])
        d //= 2
    return v[..., 0]


def _block_partials(x: torch.Tensor, op: str, blocks: int) -> torch.Tensor:
    """Each block's f32 partial, folded in the kernel's order."""
    pre, _, ident = _OPS[op]
    flat = x.reshape(-1).float()
    index, active = fold_order(flat.numel(), blocks)
    ident = torch.tensor(ident, dtype=torch.float32)
    vals = torch.where(index >= 0, pre(flat)[index.clamp(min=0)], ident)
    acc = ident.expand(index.shape[:2])
    for r in range(index.shape[2]):
        a = acc
        for s in range(index.shape[3]):
            a = _combine(op, a, vals[:, :, r, s])
        acc = torch.where(active[:, :, r], a, acc)
    return _block_fold(op, acc)


def _final_fold(partials: torch.Tensor, op: str) -> torch.Tensor:
    """The last block's fold of every partial, by index, in its warp 0:
    lane l takes partials l, l + 32, ..., then the warp fold."""
    ident = torch.tensor(_OPS[op][2], dtype=torch.float32)
    acc = ident.expand(32)
    for c in range(0, partials.numel(), 32):
        part = partials[c:c + 32]
        acc = torch.cat([_combine(op, acc[:part.numel()], part),
                         acc[part.numel():]])
    return _warp_fold(op, acc)


def _reduce_emulated(x: torch.Tensor, op: str, blocks: int) -> torch.Tensor:
    """The kernel's result on ``blocks`` blocks, computed on the CPU in the
    kernel's order of operations (the same bits, since every step is one
    rounded f32 operation)."""
    partials = _block_partials(x, op, blocks)
    return partials[0] if blocks == 1 else _final_fold(partials, op)


# --- the kernel ----------------------------------------------------------------

# loaded library -> (launch, empty launch, max blocks), ctypes types set
_ENTRY_POINTS: dict = {}
# device index -> the most blocks a launch there takes
_MAX_BLOCKS: dict = {}
# (device index, raw stream) -> f32 scratch of max_blocks + 1 words: one
# partial a block, then the ticket (a u32 that each launch leaves at 0)
_SCRATCH: dict = {}


def _entry_points():
    lib = cuda_build.load("reduce")
    fns = _ENTRY_POINTS.get(lib)
    if fns is None:
        # every argument is a 64-bit word; ctypes converts an int to
        # c_void_p faster than to c_int or c_longlong
        lib.reduce_launch.argtypes = [ctypes.c_void_p] * 8
        lib.reduce_launch.restype = ctypes.c_int
        lib.reduce_empty_launch.argtypes = [ctypes.c_void_p] * 2
        lib.reduce_empty_launch.restype = ctypes.c_int
        lib.reduce_max_blocks.argtypes = []
        lib.reduce_max_blocks.restype = ctypes.c_int
        fns = _ENTRY_POINTS[lib] = (lib.reduce_launch,
                                    lib.reduce_empty_launch,
                                    lib.reduce_max_blocks)
    return fns


def max_blocks(dev: int) -> int:
    """The most blocks a launch on CUDA device ``dev`` takes: its SM count
    times the blocks an SM holds, at most 2 (asked of the card once)."""
    got = _MAX_BLOCKS.get(dev)
    if got is None:
        with torch.cuda.device(dev):
            got = _entry_points()[2]()
        if got < 1:
            raise RuntimeError(f"reduce kernel: occupancy query failed: "
                               f"error {-got}")
        _MAX_BLOCKS[dev] = got
    return got


def _scratch(dev: int, stream: int) -> torch.Tensor:
    """The partials and ticket of launches on ``stream`` of ``dev``: made
    once, zeros; launches on one stream run one after another."""
    buf = _SCRATCH.get((dev, stream))
    if buf is None:
        buf = _SCRATCH[(dev, stream)] = torch.zeros(
            max_blocks(dev) + 1, dtype=torch.float32, device=dev)
    return buf


def _launch(fn, dev: int, *args) -> None:
    """``fn(*args)`` with device ``dev`` current; raises on a failed
    launch."""
    if dev == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"reduce kernel launch failed: error {err}")


def _reduce_cuda(x: torch.Tensor, op: str) -> torch.Tensor:
    global LAUNCHES_REDUCE
    flat = x.contiguous().view(-1)
    check_kernel_operand(flat, "reduce", (torch.float32,))
    n = flat.numel()
    if n < 1:
        raise ValueError("reduce kernel: at least one element expected")
    dev = flat.get_device()
    # the raw handle: torch.cuda.current_stream() costs several us of host
    # time a call (ops/gemv.py)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    buf = _scratch(dev, stream)
    blocks = grid(n, buf.numel() - 1)
    out = torch.empty((), dtype=torch.float32, device=flat.device)
    partial = buf.data_ptr()
    _launch(_entry_points()[0], dev, _OP_CODE[op], flat.data_ptr(), n,
            blocks, partial, partial + 4 * (buf.numel() - 1),
            out.data_ptr(), stream)
    LAUNCHES_REDUCE += 1
    return out


def launch_empty(n: int, device=None) -> None:
    """An empty kernel on the grid a reduction of ``n`` elements takes on
    ``device``: the fixed cost of one launch, for measurement. Not
    counted."""
    dev = torch.device(device or "cuda").index
    dev = torch.cuda.current_device() if dev is None else dev
    _launch(_entry_points()[1], dev, grid(n, max_blocks(dev)),
            torch._C._cuda_getCurrentRawStream(dev))


def reduce(x, op: str = "sum", *, impl: str = "auto") -> torch.Tensor:
    """Full reduction of ``x`` to a scalar under ``op``.

    ``impl``: ``"auto"`` launches the kernel for a float32 CUDA tensor with
    at least one element and runs the plain version otherwise; ``"cuda"``
    raises where ``"auto"`` would not launch; ``"torch"`` is the plain
    version.
    """
    if op not in _OPS:
        raise KeyError(f"unknown reduction {op!r}; one of {sorted(_OPS)}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    x = as_tensor(x)
    takes = (x.device.type == "cuda" and x.dtype == torch.float32
             and x.numel() >= 1)
    if impl == "cuda" and not takes:
        raise ValueError(
            "reduce kernel takes a float32 CUDA tensor with at least one "
            f"element, got {x.dtype} on {x.device} with {x.numel()}")
    if impl != "torch" and takes:
        return _reduce_cuda(x, op)
    return _reduce_torch(x, op)


def eval_cpu(x: np.ndarray, op: str):
    """NumPy oracle."""
    x = np.asarray(x)
    return {
        "sum": np.sum, "prod": np.prod, "min": np.min, "max": np.max,
        "sqnorm": lambda v: np.sum(v * v),
    }[op](x)


def _example_args(device):
    return (torch.ones((8192,), dtype=torch.float32, device=device),)


register_module(
    KernelModule(
        "linalg.reduce",
        provides={"reduce": reduce},
        entries={
            name: EntryPoint(fn=functools.partial(reduce, op=name),
                             example_args=_example_args)
            for name in _OPS
        },
        doc="Scalar reductions min/max/sum/prod/sqnorm.",
    )
)
