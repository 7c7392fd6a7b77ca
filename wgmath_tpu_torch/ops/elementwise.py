"""Elementwise op-assign family (counterpart of
``wgmath_tpu/ops/elementwise.py``, the reference's ``OpAssign``).

The reference ships one kernel with a placeholder function that its
composer redirects per variant (add / sub / mul / div / copy). Here the
redirect is a parameter:

- :func:`op_assign` is plain tensor code; ``op`` is a variant name or *any*
  binary Python callable.
- :func:`op_assign_kernel` is the single-kernel form, written by hand in
  Triton. It replaces the TPU kernel ``op_assign_pallas`` of the JAX
  package. The binary function is passed to the kernel as a ``tl.constexpr``
  ``@triton.jit`` function and specialised at the first launch, which a
  library built ahead of time cannot do for a caller's own function: that
  is why this kernel is Triton and not CUDA C++. The five named variants are
  five small jitted functions; a caller's redirect is any ``@triton.jit``
  binary function. One program handles one block of ``BLOCK`` elements of
  the flattened arrays and masks the tail, so any shape is taken.

  Bound on the card: bytes (two arrays read, one written, one operation an
  element: 12 bytes an element at 3.35 TB/s, 15 us for 2048 x 2048 f32).

``triton`` is imported inside the launching function: the machine that runs
the CPU tests has none.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from wgmath_tpu_torch.core.dispatch import as_tensor, check_kernel_operand
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)

VARIANTS: dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "copy": lambda a, b: b,
}

LAUNCHES_OP_ASSIGN = 0
BLOCK = 1024  # elements per program (a power of two)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)
_TRITON: dict = {}  # the jitted kernel and variants, made at first launch


def op_assign(a, b, op="add") -> torch.Tensor:
    """Return ``a <op>= b`` (functional: a new tensor).

    ``op`` is a variant name or any binary callable (the redirect
    mechanism).
    """
    a = as_tensor(a)
    b = as_tensor(b, a.device)
    fn = VARIANTS[op] if isinstance(op, str) else op
    return fn(a, b)


def _triton_kernels() -> dict:
    """The Triton kernel and the five jitted variants, defined at first use.
    The jitted functions name ``tl`` as a module global: Triton resolves a
    jitted function's names in its ``__globals__``."""
    if _TRITON:
        return _TRITON
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def _add(a, b):
        return a + b

    @triton.jit
    def _sub(a, b):
        return a - b

    @triton.jit
    def _mul(a, b):
        return a * b

    @triton.jit
    def _div(a, b):
        return a / b

    @triton.jit
    def _copy(a, b):
        return b

    @triton.jit
    def _op_assign_kernel(a_ptr, b_ptr, out_ptr, n, FN: tl.constexpr,
                          BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        a = tl.load(a_ptr + offs, mask=mask)
        b = tl.load(b_ptr + offs, mask=mask)
        tl.store(out_ptr + offs, FN(a, b), mask=mask)

    _TRITON.update(triton=triton, kernel=_op_assign_kernel, add=_add,
                   sub=_sub, mul=_mul, div=_div, copy=_copy)
    return _TRITON


def _op_assign_triton(a, b, op):
    global LAUNCHES_OP_ASSIGN
    check_kernel_operand(a, "op_assign_kernel: a", _KERNEL_DTYPES)
    check_kernel_operand(b, "op_assign_kernel: b", (a.dtype,))
    if b.device != a.device:
        raise ValueError("op_assign_kernel: operands on different devices")
    k = _triton_kernels()
    if isinstance(op, str):
        fn = k[op]
    elif isinstance(op, k["triton"].runtime.JITFunction):
        fn = op
    else:
        raise TypeError(
            "op_assign_kernel: on a CUDA tensor the redirected op must be a "
            "variant name or a @triton.jit binary function (decorate your "
            "function with @triton.jit, or call op_assign for a plain "
            "Python callable)")
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        k["kernel"][(k["triton"].cdiv(n, BLOCK),)](
            a, b, out, n, FN=fn, BLOCK=BLOCK, num_warps=4)
    LAUNCHES_OP_ASSIGN += 1
    return out


def op_assign_kernel(a, b, op="add") -> torch.Tensor:
    """Single-kernel ``a <op>= b`` over the flattened arrays (a new tensor
    of ``a``'s shape and type).

    On a CUDA tensor it launches the Triton kernel; ``op`` is a variant
    name or a ``@triton.jit`` binary function. On a CPU tensor it runs the
    plain version, :func:`op_assign`; ``op`` is a variant name or a Python
    callable.
    """
    a = as_tensor(a)
    b = as_tensor(b, a.device)
    if isinstance(op, str) and op not in VARIANTS:
        raise KeyError(f"unknown op_assign variant {op!r}; "
                       f"one of {sorted(VARIANTS)}")
    if a.shape != b.shape:
        raise ValueError(f"op_assign_kernel: shapes differ, {tuple(a.shape)} "
                         f"vs {tuple(b.shape)}")
    if a.device.type == "cuda":
        return _op_assign_triton(a, b, op)
    if a.device.type == "cpu":
        if not isinstance(op, str) and not callable(op):
            raise TypeError("op_assign_kernel: op must be a variant name or "
                            "a binary callable")
        return op_assign(a, b, op)
    raise ValueError(f"op_assign_kernel: unsupported device {a.device}")


def _example_args(device):
    return (torch.zeros((128, 128), dtype=torch.float32, device=device),
            torch.ones((128, 128), dtype=torch.float32, device=device))


register_module(
    KernelModule(
        "linalg.op_assign",
        provides={"op_assign": op_assign, **VARIANTS},
        entries={
            name: EntryPoint(
                fn=functools.partial(op_assign_kernel, op=name),
                example_args=_example_args,
            )
            for name in VARIANTS
        },
        doc="Elementwise a ?= b family with callable redirection.",
    )
)
