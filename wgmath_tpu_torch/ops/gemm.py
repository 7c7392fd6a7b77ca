"""Batched GEMM (counterpart of ``wgmath_tpu/ops/gemm.py``, the reference's
``Gemm`` with its plain and transposed pipelines).

- :func:`gemm` — ``op(a) @ op(b)`` over leading batch dimensions, either
  operand stored transposed (a flag: nothing is transposed in memory), a
  single-matrix operand broadcast over the other's batch. On CUDA tensors
  of one type, float32 or bfloat16, it launches the hand-written kernel
  ``csrc/gemm.cu``, which replaces the TPU kernel ``_gemm_pallas``: f32
  accumulation, output in the input type, any M, N, K >= 1 (the alignment
  gate of the JAX package belongs to the TPU's matrix unit and has no
  counterpart here).
- :func:`gemm_torch` — the plain library route (twin of ``gemm_xla``) and
  the kernel's plain version: ``torch.matmul`` with f32 accumulation.
- :func:`gemm_split` — f32 product from operands split once into three bf16
  planes (:func:`_split3`, by mantissa bitmask), 6 or 3 cross terms summed
  low order first; on CUDA tensors the kernel ``csrc/gemm_split.cu`` (bf16
  tensor-core passes on the planes, zero-padded to its tile multiples),
  which replaces the TPU kernel of the JAX ``gemm_split``.

``impl``: ``"auto"`` (the kernel on CUDA tensors, the plain version on CPU
tensors), ``"cuda"`` (raises on a CPU tensor and on a type or precision the
kernel does not take) and ``"torch"`` (the plain library route).

Precision. For float32 inputs the kernel runs 3 x TF32 on the tensor
cores, whatever ``precision`` says: each operand split into a TF32 ``big``
and ``small`` part, ``small·big + big·small`` then ``+ big·big`` summed in
f32 (:func:`_gemm_3xtf32_torch` is the same arithmetic in plain PyTorch).
``"highest"`` and ``"default"`` give the same bits, both inside the
reference's 1e-3 golden tolerance. ``"high"`` goes to :func:`gemm_torch`,
as the JAX package sends it to its library route outside any kernel.
"""

from __future__ import annotations

import ctypes

import torch

from wgmath_tpu_torch.core.dispatch import as_tensor
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)

IMPLS = ("auto", "cuda", "torch")
PRECISIONS = ("default", "high", "highest")
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES_GEMM = 0
LAUNCHES_GEMM_SPLIT = 0


def _op_shape(x, t):
    return (x.shape[-1], x.shape[-2]) if t else (x.shape[-2], x.shape[-1])


def gemm(a, b, *, transpose_a: bool = False, transpose_b: bool = False,
         precision: str = "highest", impl: str = "auto") -> torch.Tensor:
    """Batched matrix product ``op(a) @ op(b)``.

    ``a``: ``[..., M, K]`` (or ``[..., K, M]`` if ``transpose_a``);
    ``b``: ``[..., K, N]`` (or ``[..., N, K]`` if ``transpose_b``).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    a = as_tensor(a)
    b = as_tensor(b, a.device)
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError("gemm operands must be rank >= 2")
    m, ka = _op_shape(a, transpose_a)
    kb, n = _op_shape(b, transpose_b)
    if ka != kb:
        raise ValueError(f"inner dims mismatch: {ka} vs {kb}")
    if a.device != b.device:
        raise ValueError(f"gemm operands on different devices: {a.device} "
                         f"vs {b.device}")

    takes = (a.device.type == "cuda" and precision != "high"
             and a.dtype == b.dtype and a.dtype in _KERNEL_DTYPES
             and min(m, n, ka) >= 1)
    if impl == "cuda" and not takes:
        raise ValueError(
            "gemm kernel takes CUDA tensors of one type (float32 or "
            "bfloat16), non-empty, at precision 'highest' or 'default'; got "
            f"{a.dtype} / {b.dtype} on {a.device}, precision {precision!r}, "
            f"m={m} n={n} k={ka}")
    if impl != "torch" and takes:
        return _gemm_cuda(a, b, transpose_a, transpose_b, m, n, ka)
    return gemm_torch(a, b, transpose_a=transpose_a, transpose_b=transpose_b)


def gemm_torch(a, b, *, transpose_a: bool = False,
               transpose_b: bool = False) -> torch.Tensor:
    """Plain library route: ``torch.matmul`` in the operands' promoted type,
    16-bit floats accumulated in f32 and rounded once (no TF32 switch is
    touched: a float32 product is a full float32 product)."""
    if transpose_a:
        a = a.swapaxes(-1, -2)
    if transpose_b:
        b = b.swapaxes(-1, -2)
    dt = torch.promote_types(a.dtype, b.dtype)
    work = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
    return torch.matmul(a.to(work), b.to(work)).to(dt)


def _matrices(x: torch.Tensor):
    """``x`` as [nb, rows, cols] with a unit inner stride; returns the
    tensor, its row stride and its batch stride."""
    x3 = x.reshape((-1,) + tuple(x.shape[-2:]))
    nb, rows, cols = x3.shape
    if (cols > 1 and x3.stride(2) != 1) or \
            (rows > 1 and x3.stride(1) < cols):
        x3 = x3.contiguous()
    # a dimension of extent 1 may carry any stride: name the dense one
    return (x3, x3.stride(1) if rows > 1 else cols,
            x3.stride(0) if nb > 1 else 0)


def _gemm_cuda(a, b, ta, tb, m, n, k):
    global LAUNCHES_GEMM
    from wgmath_tpu_torch.core import cuda_build

    a3, lda, batch_a = _matrices(a)
    b3, ldb, batch_b = _matrices(b)
    nb = 0 if 0 in (a3.shape[0], b3.shape[0]) else \
        max(a3.shape[0], b3.shape[0])
    batch_shape = (a if a3.shape[0] >= b3.shape[0] else b).shape[:-2]
    # a single-matrix operand is broadcast by its batch stride of 0
    if a3.shape[0] != b3.shape[0] and 1 not in (a3.shape[0], b3.shape[0]):
        raise ValueError("batch dims mismatch")
    out = torch.empty((nb, m, n), dtype=a.dtype, device=a.device)
    if nb == 0:
        return out.reshape(tuple(batch_shape) + (m, n))
    fn = cuda_build.load("gemm").gemm_launch
    fn.argtypes = ([ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   * 2 + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(_KERNEL_DTYPES[a.dtype], int(ta), int(tb), nb, m, n, k,
                 a3.data_ptr(), lda, batch_a, b3.data_ptr(), ldb, batch_b,
                 out.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm kernel launch failed: error {err}")
    LAUNCHES_GEMM += 1
    return out.reshape(tuple(batch_shape) + (m, n))


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, by integer ops on the bits: what ``cvt.rna.tf32.f32`` gives, with
    the low 13 bits 0."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _gemm_3xtf32_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The arithmetic of the gemm kernel on f32 operands: each split into
    ``big = tf32(x)`` and ``small = tf32(x - big)``, then
    ``(small_a·big_b + big_a·small_b) + big_a·big_b`` as f32 products of
    TF32 values (exact products, f32 sums). Used by tests."""
    big_a, big_b = _round_tf32(a), _round_tf32(b)
    small_a, small_b = _round_tf32(a - big_a), _round_tf32(b - big_b)
    return (small_a @ big_b + big_a @ small_b) + big_a @ big_b


def _split3(x: torch.Tensor) -> torch.Tensor:
    """f32 -> three bf16 planes (hi, mid, lo) with x = hi + mid + lo.

    Each plane takes the next 8 mantissa bits of the residual, carved by
    mantissa bitmask: the masked upper 16 bits convert to bf16 exactly and
    the f32 subtractions are exact, so hi and mid hold no rounding and the
    planes are bit for bit those of the JAX package."""
    hi_f = (x.view(torch.int32) & -65536).view(torch.float32)
    r = x - hi_f  # exact: hi_f is x with the low 16 mantissa bits cleared
    mid_f = (r.view(torch.int32) & -65536).view(torch.float32)
    lo = (r - mid_f).to(torch.bfloat16)  # exact residual, then rounded
    return torch.stack([hi_f.to(torch.bfloat16), mid_f.to(torch.bfloat16),
                        lo])


def _gemm_split_torch(a_planes, b_planes, n_passes: int) -> torch.Tensor:
    """Plain version: the planes widened to f32, six or three products,
    summed low order first."""
    ah, am = a_planes[0].float(), a_planes[1].float()
    bh, bm = b_planes[0].float(), b_planes[1].float()
    acc = am @ bh + ah @ bm
    if n_passes == 6:
        al, bl = a_planes[2].float(), b_planes[2].float()
        acc = (al @ bh + am @ bm + ah @ bl) + acc
    return acc + ah @ bh


# the kernel's output tile (M x N) and k tile; TMA reads the planes in
# whole tiles, so they are zero-padded to these multiples (zeros add nothing)
SPLIT_TILE_M, SPLIT_TILE_N, SPLIT_TILE_K = 128, 64, 64


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def _gemm_split_cuda(a_planes, b_planes, n_passes: int) -> torch.Tensor:
    global LAUNCHES_GEMM_SPLIT
    from wgmath_tpu_torch.core import cuda_build

    n_split = 3 if n_passes == 6 else 2
    ap = a_planes[:n_split].contiguous()
    bp = b_planes[:n_split].contiguous()
    _, m, k = ap.shape
    n = bp.shape[2]
    mp, np_, kp = (_round_up(m, SPLIT_TILE_M), _round_up(n, SPLIT_TILE_N),
                   _round_up(k, SPLIT_TILE_K))
    if (mp, kp) != (m, k):
        ap = torch.nn.functional.pad(ap, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        bp = torch.nn.functional.pad(bp, (0, np_ - n, 0, kp - k))
    out = torch.empty((mp, np_), dtype=torch.float32, device=ap.device)
    fn = cuda_build.load("gemm_split").gemm_split_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(ap.device):
        err = fn(n_split, mp, np_, kp, ap.data_ptr(), bp.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(ap.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_split kernel launch failed: error {err}")
    LAUNCHES_GEMM_SPLIT += 1
    return out if (mp, np_) == (m, n) else out[:m, :n].contiguous()


def gemm_split(a, b, *, n_passes: int = 6) -> torch.Tensor:
    """f32 GEMM via bf16 planes split once and multi-pass accumulation.

    ``n_passes``: 6 keeps every cross term at or above lo.hi (f32-product
    accuracy); 3 keeps {hi.hi, hi.mid, mid.hi}, which meets the reference's
    1e-3 golden tolerance. 2-D float32 only; use :func:`gemm` for batched
    and transposed products. On CUDA tensors it launches the kernel, on CPU
    tensors it runs the plain version.
    """
    a = as_tensor(a)
    b = as_tensor(b, a.device)
    if n_passes not in (6, 3):
        raise ValueError(f"gemm_split: n_passes must be 6 or 3, got "
                         f"{n_passes}")
    if a.ndim != 2 or b.ndim != 2 or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise ValueError("gemm_split takes two 2-D float32 matrices, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} "
                         f"{b.dtype}")
    if a.shape[1] != b.shape[0] or 0 in a.shape or 0 in b.shape:
        raise ValueError(f"inner dims mismatch or empty operand: "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"gemm_split operands on different devices: "
                         f"{a.device} vs {b.device}")
    a_planes = _split3(a.contiguous())
    b_planes = _split3(b.contiguous())
    if a.device.type == "cuda":
        return _gemm_split_cuda(a_planes, b_planes, n_passes)
    if a.device.type == "cpu":
        return _gemm_split_torch(a_planes, b_planes, n_passes)
    raise ValueError(f"gemm_split: unsupported device {a.device}")


def _zeros(*shape):
    return lambda device: (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device))


register_module(
    KernelModule(
        "linalg.gemm",
        deps=(),
        provides={"gemm": gemm, "gemm_torch": gemm_torch},
        entries={
            "gemm": EntryPoint(fn=lambda a, b: gemm(a, b),
                               example_args=_zeros(256, 256)),
            "gemm_tr": EntryPoint(
                fn=lambda a, b: gemm(a, b, transpose_a=True),
                example_args=_zeros(2, 256, 256)),
        },
        doc="Batched tiled GEMM.",
    )
)
