"""Vector reductions (counterpart of ``wgmath_tpu/ops/reduce.py``, the
reference's ``Reduce``): min / max / sum / prod / sqnorm of an array to one
scalar.

On a CUDA tensor of float32, :func:`reduce` launches the hand-written kernel
``csrc/reduce.cu`` (two stages, no atomics, bitwise repeatable), which
replaces the TPU kernel ``_reduce_pallas``. Any length >= 1 is taken; the
array is reduced through its flattened contiguous form. The result stays
on the device: no host sync. On a CPU tensor, and for other types, it runs
the plain version :func:`_reduce_torch`. ``eval_cpu`` is the NumPy oracle.

min and max return NaN when any element is NaN, in the kernel and in the
plain version alike.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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

LAUNCHES_REDUCE = 0


def _reduce_torch(x: torch.Tensor, op: str) -> torch.Tensor:
    """Plain version: the pre-map, then one full reduction (an empty array
    gives the identity)."""
    pre, full, ident = _OPS[op]
    if x.numel() == 0:
        return torch.full((), ident, dtype=x.dtype, device=x.device)
    return full(pre(x))


def _reduce_cuda(x: torch.Tensor, op: str) -> torch.Tensor:
    global LAUNCHES_REDUCE
    from wgmath_tpu_torch.core import cuda_build

    flat = x.contiguous().view(-1)
    check_kernel_operand(flat, "reduce", (torch.float32,))
    n = flat.numel()
    if n < 1:
        raise ValueError("reduce kernel: at least one element expected")
    lib = cuda_build.load("reduce")
    lib.reduce_blocks.argtypes = [ctypes.c_longlong]
    lib.reduce_blocks.restype = ctypes.c_int
    fn = lib.reduce_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    partial = torch.empty(lib.reduce_blocks(n), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(_OP_CODE[op], flat.data_ptr(), n, partial.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"reduce kernel launch failed: error {err}")
    LAUNCHES_REDUCE += 1
    return out


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
