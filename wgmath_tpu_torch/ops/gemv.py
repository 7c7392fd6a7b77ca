"""Batched GEMV (counterpart of ``wgmath_tpu/ops/gemv.py``, the reference's
``Gemv`` with its plain and transposed kernels).

- :func:`gemv` — ``op(a) @ x`` for ``a: [..., M, K]`` (``[..., K, M]`` with
  ``transpose_a``) and ``x: [..., K]``, batch dimensions broadcast. On CUDA
  tensors of float32 it launches the hand-written kernels of
  ``csrc/gemv.cu``: ``gemv_rows`` for ``A·x`` (replaces ``_gemv_pallas``)
  and ``gemv_tr_cols`` for ``Aᵀ·x`` (replaces ``_gemv_tr_pallas``), for any
  M, K >= 1 and any batch. The JAX package's alignment gate belongs to the
  TPU's tiles and has no counterpart here.
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


# loaded library -> its entry points with their ctypes signatures set
_ENTRY_POINTS: dict = {}


def _entry_points():
    lib = cuda_build.load("gemv")
    fns = _ENTRY_POINTS.get(lib)
    if fns is None:
        common = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_longlong, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_void_p]
        lib.gemv_tr_splits.argtypes = [ctypes.c_int] * 3
        lib.gemv_launch.argtypes = common + [ctypes.c_void_p]
        lib.gemv_tr_launch.argtypes = common + [ctypes.c_void_p] * 2
        for fn in (lib.gemv_tr_splits, lib.gemv_launch, lib.gemv_tr_launch):
            fn.restype = ctypes.c_int
        fns = _ENTRY_POINTS[lib] = (lib.gemv_tr_splits, lib.gemv_launch,
                                    lib.gemv_tr_launch)
    return fns


def _operands(a, x, k):
    """(A as [nb_a, rows, cols] with a unit inner stride, its row stride,
    its batch stride, x as contiguous [nb_x, k], its batch stride, the
    output's batch shape). The one-matrix, one-vector case is kept short:
    it is the chained path's, where the host's time per call is the
    iteration's."""
    if a.ndim == 2 and x.ndim == 1:
        rows, cols = a.shape
        if a.stride(1) != 1 or (rows > 1 and a.stride(0) < cols):
            a = a.contiguous()
        return (a, a.stride(0) if rows > 1 else cols, 0, x.contiguous(), 0,
                ())
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


def _gemv_cuda(a, x, transpose_a, m, k):
    global LAUNCHES_GEMV, LAUNCHES_GEMV_TR
    a3, lda, batch_a, x2, batch_x, batch_shape = _operands(a, x, k)
    nb = math.prod(batch_shape)
    out = torch.empty(tuple(batch_shape) + (m,), dtype=torch.float32,
                      device=a.device)
    if nb == 0:
        return out
    splits_of, launch, launch_tr = _entry_points()
    splits = splits_of(m, k, nb) if transpose_a else 1
    # the transposed kernel's partial sums, one row of M per K chunk
    partial = (torch.empty(nb * splits * m, dtype=torch.float32,
                           device=a.device) if splits > 1 else out)
    args = (nb, m, k, a3.data_ptr(), lda, batch_a, x2.data_ptr(), batch_x,
            out.data_ptr())

    def run():
        # the raw handle of the current stream: torch.cuda.current_stream()
        # costs 7-10 us of host time a call on the card's host, this 0.2,
        # and the chained GEMV is bound by its wrapper's host time
        stream = torch._C._cuda_getCurrentRawStream(a.device.index)
        if transpose_a:
            return launch_tr(*args, partial.data_ptr(), stream)
        return launch(*args, stream)

    if a.device.index == torch.cuda.current_device():
        err = run()
    else:
        with torch.cuda.device(a.device):
            err = run()
    if err != 0:
        raise RuntimeError(f"gemv kernel launch failed: error {err}")
    if transpose_a:
        LAUNCHES_GEMV_TR += 1
    else:
        LAUNCHES_GEMV += 1
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
