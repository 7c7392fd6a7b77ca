"""Strided views over flat buffers (counterpart of
``wgmath_tpu/core/tensor.py``, the reference's tensor views / ``ViewShape``).

A :class:`View` describes a strided rank-<=3 window into a flat storage
buffer with the same vocabulary as the JAX package: ``column``, ``columns``,
``rows``, ``matrix``, ``reshape``. It is a plain dataclass around a 1-D
``torch.Tensor`` (PyTorch needs no pytree registration).

Convention, as in the JAX package: matrices are column-major *logically* —
``shape = (nrows, ncols, nmats)``, a column is contiguous along
``stride = 1`` — and dense arrays are indexed ``[mat, col, row]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from wgmath_tpu_torch.core.dispatch import as_tensor


@dataclasses.dataclass
class View:
    """A strided rank-<=3 window into a flat buffer.

    ``shape = (nrows, ncols, nmats)``; element (i, j, k) lives at flat index
    ``offset + i + j*stride + k*stride_mat``.
    """

    buffer: torch.Tensor  # flat 1-D storage
    shape: tuple[int, int, int]
    stride: int
    stride_mat: int
    offset: int

    # -- view algebra -------------------------------------------------------
    def column(self, j: int) -> "View":
        return View(self.buffer, (self.shape[0], 1, 1), self.stride,
                    self.stride_mat, self.offset + j * self.stride)

    def columns(self, j: int, n: int) -> "View":
        return View(self.buffer, (self.shape[0], n, self.shape[2]),
                    self.stride, self.stride_mat,
                    self.offset + j * self.stride)

    def rows(self, i: int, n: int) -> "View":
        return View(self.buffer, (n, self.shape[1], self.shape[2]),
                    self.stride, self.stride_mat, self.offset + i)

    def matrix(self, k: int) -> "View":
        return View(self.buffer, (self.shape[0], self.shape[1], 1),
                    self.stride, self.stride_mat,
                    self.offset + k * self.stride_mat)

    def reshape(self, nrows: int, ncols: int, nmats: int = 1) -> "View":
        if nrows * ncols * nmats != \
                self.shape[0] * self.shape[1] * self.shape[2]:
            raise ValueError("reshape must preserve element count")
        if not self.is_contiguous():
            raise ValueError("reshape requires a contiguous view")
        return View(self.buffer, (nrows, ncols, nmats), nrows, nrows * ncols,
                    self.offset)

    def is_contiguous(self) -> bool:
        return (self.stride == self.shape[0]
                and self.stride_mat == self.shape[0] * self.shape[1])

    # -- materialization ----------------------------------------------------
    def to_array(self) -> torch.Tensor:
        """Materialize as a dense ``[nmats, ncols, nrows]`` tensor."""
        nrows, ncols, nmats = self.shape
        dev = self.buffer.device
        i = torch.arange(nrows, device=dev)
        j = torch.arange(ncols, device=dev) * self.stride
        k = torch.arange(nmats, device=dev) * self.stride_mat
        idx = (self.offset + k[:, None, None] + j[None, :, None]
               + i[None, None, :])
        return self.buffer[idx]

    def to_matrix(self) -> torch.Tensor:
        """Materialize as ``[nrows, ncols]`` (rank<=2 views only)."""
        if self.shape[2] != 1:
            raise ValueError("to_matrix requires nmats == 1")
        return self.to_array()[0].T

    def to_vector(self) -> torch.Tensor:
        if self.shape[1] != 1 or self.shape[2] != 1:
            raise ValueError("to_vector requires ncols == nmats == 1")
        return self.to_array()[0, 0]


def view_of(x: Any, device=None) -> View:
    """Wrap a dense array (vector [n], matrix [r, c], cube [m, c, r] batched)
    as a contiguous column-major View. A tensor stays on its device; an
    array-like goes to ``device`` (the card by default)."""
    x = as_tensor(x, device)
    if x.ndim == 1:
        n = x.shape[0]
        return View(x, (n, 1, 1), n, n, 0)
    if x.ndim == 2:
        r, c = x.shape
        # store column-major: buffer index = i + j*r, the flattened x.T
        return View(x.T.reshape(-1), (r, c, 1), r, r * c, 0)
    if x.ndim == 3:
        m, c, r = x.shape  # batched: [mat, col, row]
        return View(x.reshape(-1), (r, c, m), r, r * c, 0)
    raise ValueError(f"rank {x.ndim} > 3 unsupported")
