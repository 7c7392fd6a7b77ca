"""Batched GEMV (counterpart of ``wgmath_tpu/ops/gemv.py``, the reference's
``Gemv`` with its plain and transposed kernels).

- :func:`gemv` — ``op(a) @ x`` for ``a: [..., M, K]`` (``[..., K, M]`` with
  ``transpose_a``) and ``x: [..., K]``, batch dimensions broadcast. On CUDA
  tensors of float32 it makes one launch of a hand-written kernel of
  ``csrc/gemv.cu``: ``gemv_rows`` for ``A·x`` (replaces ``_gemv_pallas``)
  and ``gemv_tr_cols`` for ``Aᵀ·x`` (replaces ``_gemv_tr_pallas``; its K
  split is added inside the launch, across a thread-block cluster), for
  any M, K >= 1 and any batch, allocating nothing but the output. The JAX
  package's alignment gate belongs to the TPU's tiles and has no
  counterpart here.
- :func:`plan` — the launch shape the kernels take for given shapes.
- :func:`gemv_torch` — the kernels' plain version: the elementwise product,
  then a sum over K, as the Pallas kernels' bodies compute it. It runs for
  CPU tensors.
- :func:`gemv_xla` — the einsum twin of the JAX package's ``gemv_xla``.

``impl``: ``"auto"`` (the kernel on CUDA tensors, the plain version on CPU
tensors), ``"cuda"`` (raises on a CPU tensor) and ``"torch"`` (the plain
version). On a CUDA tensor the kernel is launched or the call raises:
there is no silent plain route on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from wgmath_tpu_torch.core import cuda_build
from wgmath_tpu_torch.core.dispatch import as_tensor
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)
from wgmath_tpu_torch.ops.gemm import _matrices

IMPLS = ("auto", "cuda", "torch")

LAUNCHES_GEMV = 0
LAUNCHES_GEMV_TR = 0


def gemv(a, x, *, transpose_a: bool = False,
         impl: str = "auto") -> torch.Tensor:
    """``op(a) @ x`` for ``a: [..., M, K]``, ``x: [..., K]``: ``[..., M]``."""
    # one float32 matrix and vector on the card (the chained path, where
    # the host's time per call is the iteration's) in few host operations;
    # every other case, and every refusal, takes the checks below. This
    # path only narrows those checks: it never accepts what they refuse
    if (impl == "auto" or impl == "cuda") and type(a) is torch.Tensor \
            and type(x) is torch.Tensor and a.is_cuda \
            and a.dtype is torch.float32 and x.dtype is torch.float32 \
            and a.dim() == 2 and x.dim() == 1:
        dev = a.get_device()
        rows, cols = a.shape
        k, m = (rows, cols) if transpose_a else (cols, rows)
        if x.get_device() == dev and x.shape[0] == k and m and k:
            return _gemv_2d(a, x, transpose_a, m, k, dev)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    a = as_tensor(a)
    x = as_tensor(x, a.device)
    m, k = (a.shape[-1], a.shape[-2]) if transpose_a else \
        (a.shape[-2], a.shape[-1])
    if x.shape[-1] != k:
        raise ValueError(f"gemv inner dim mismatch: {tuple(a.shape)} vs "
                         f"{tuple(x.shape)}")
    if a.device != x.device:
        raise ValueError(f"gemv operands on different devices: {a.device} "
                         f"vs {x.device}")
    if impl == "torch" or (impl == "auto" and a.device.type == "cpu"):
        return gemv_torch(a, x, transpose_a=transpose_a)
    if a.device.type != "cuda" or a.dtype != torch.float32 \
            or x.dtype != torch.float32 or min(m, k) < 1:
        raise ValueError(
            "gemv kernel takes non-empty float32 CUDA tensors; got "
            f"{a.dtype} / {x.dtype} on {a.device}, m={m} k={k}")
    return _gemv_cuda(a, x, transpose_a, m, k)


def gemv_torch(a: torch.Tensor, x: torch.Tensor, *,
               transpose_a: bool = False) -> torch.Tensor:
    """Plain version: the elementwise product, then the sum over K."""
    if transpose_a:
        return torch.sum(a * x[..., :, None], dim=-2)
    return torch.sum(a * x[..., None, :], dim=-1)


def gemv_xla(a: torch.Tensor, x: torch.Tensor, *,
             transpose_a: bool = False) -> torch.Tensor:
    """The einsum twin of the JAX package's library route."""
    if transpose_a:
        a = a.swapaxes(-1, -2)
    return torch.einsum("...mk,...k->...m", a, x)


# loaded library -> (A x launch, A^T x launch, plan), ctypes types set
_ENTRY_POINTS: dict = {}


def _entry_points():
    lib = cuda_build.load("gemv")
    fns = _ENTRY_POINTS.get(lib)
    if fns is None:
        for fn in (lib.gemv_launch, lib.gemv_tr_launch):
            # every argument is a 64-bit word; ctypes converts an int to
            # c_void_p faster than to c_int or c_longlong
            fn.argtypes = [ctypes.c_void_p] * 10
            fn.restype = ctypes.c_int
        lib.gemv_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gemv_plan.restype = None
        fns = _ENTRY_POINTS[lib] = (lib.gemv_launch, lib.gemv_tr_launch,
                                    lib.gemv_plan)
    return fns


def plan(m: int, k: int, nb: int = 1, *, transpose_a: bool = False) -> dict:
    """The launch shape the kernel takes for these shapes (a function of
    the shapes alone, on any card): grid, cluster blocks (the K split of
    ``Aᵀ·x``), rows of K per block and tile width. For reports; a launch
    does not query it."""
    out = (ctypes.c_int * 6)()
    _entry_points()[2](int(transpose_a), nb, m, k, out)
    return {"grid": tuple(out[:3]), "cluster": out[3], "chunk": out[4],
            "tile": out[5]}


def _operands(a, x, k):
    """(A as [nb_a, rows, cols] with a unit inner stride, its row stride,
    its batch stride, x as contiguous [nb_x, k], its batch stride, the
    output's batch shape)."""
    batch_shape = torch.broadcast_shapes(a.shape[:-2], x.shape[:-1])
    nb = batch_shape.numel()
    # an operand the whole batch shares keeps its batch stride of 0; one
    # broadcast over part of the batch is expanded
    if a.shape[:-2].numel() not in (1, nb):
        a = a.expand(batch_shape + a.shape[-2:])
    if x.shape[:-1].numel() not in (1, nb):
        x = x.expand(batch_shape + x.shape[-1:])
    a3, lda, batch_a = _matrices(a)
    x2 = x.reshape(-1, k).contiguous()
    return a3, lda, batch_a, x2, k if x2.shape[0] > 1 else 0, batch_shape


def _launch(dev, transpose_a, *args):
    """One launch on the current stream of device ``dev``, counted;
    ``args`` are the entry point's but the stream."""
    global LAUNCHES_GEMV, LAUNCHES_GEMV_TR
    launch = _entry_points()[1 if transpose_a else 0]
    # the raw handle of the current stream: torch.cuda.current_stream()
    # costs 7-10 us of host time a call on the card's host, this 0.2, and
    # the chained GEMV is bound by its wrapper's host time
    if dev == torch._C._cuda_getDevice():
        err = launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"gemv kernel launch failed: error {err}")
    if transpose_a:
        LAUNCHES_GEMV_TR += 1
    else:
        LAUNCHES_GEMV += 1


def _gemv_2d(a, x, transpose_a, m, k, dev):
    """One matrix, one vector on device ``dev``: the chained path's case."""
    rows, cols = a.shape
    lda = a.stride(0) if rows > 1 else cols
    if a.stride(1) != 1 or lda < cols:
        a = a.contiguous()
        lda = cols
    if x.stride(0) != 1:
        x = x.contiguous()
    out = a.new_empty(m)
    _launch(dev, transpose_a, 1, m, k, a.data_ptr(), lda, 0, x.data_ptr(),
            0, out.data_ptr())
    return out


def _gemv_cuda(a, x, transpose_a, m, k):
    a3, lda, batch_a, x2, batch_x, batch_shape = _operands(a, x, k)
    nb = math.prod(batch_shape)
    out = torch.empty(tuple(batch_shape) + (m,), dtype=torch.float32,
                      device=a.device)
    if nb == 0:
        return out
    _launch(a.get_device(), transpose_a, nb, m, k, a3.data_ptr(), lda,
            batch_a, x2.data_ptr(), batch_x, out.data_ptr())
    return out


register_module(
    KernelModule(
        "linalg.gemv",
        provides={"gemv": gemv, "gemv_xla": gemv_xla},
        entries={
            "gemv": EntryPoint(
                fn=lambda a, x: gemv(a, x),
                example_args=lambda device: (
                    torch.zeros((256, 256), device=device),
                    torch.zeros((256,), device=device),
                ),
            ),
            "gemv_tr": EntryPoint(
                fn=lambda a, x: gemv(a, x, transpose_a=True),
                example_args=lambda device: (
                    torch.zeros((4, 128, 128), device=device),
                    torch.zeros((4, 128), device=device),
                ),
            ),
        },
        doc="Batched GEMV.",
    )
)
