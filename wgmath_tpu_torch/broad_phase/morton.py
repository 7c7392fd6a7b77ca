"""Morton codes and bit utilities (counterpart of
``wgmath_tpu/broad_phase/morton.py``).

The JAX package works in uint32. PyTorch has no unsigned 32-bit arithmetic,
so every function here works in int64 and masks each result to its low 32
bits: the codes and counts are the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int64) & _M32


def expand_bits_3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = _u32(v)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def expand_bits_2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of v so consecutive bits are 2 apart."""
    v = _u32(v)
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_codes(points: torch.Tensor, domain_min: torch.Tensor,
                 domain_max: torch.Tensor) -> torch.Tensor:
    """Quantize points into the domain box and interleave the bits: 10 bits
    an axis in 3D (30-bit codes), 16 in 2D (32-bit codes); int64 values in
    [0, 2^32)."""
    dim = points.shape[-1]
    extent = torch.clamp(domain_max - domain_min, min=1e-9)
    unit = (points - domain_min) / extent
    if dim == 3:
        q = torch.clamp(unit * 1024.0, 0.0, 1023.0).to(torch.int64)
        return (expand_bits_3(q[..., 0]) << 2 | expand_bits_3(q[..., 1]) << 1
                | expand_bits_3(q[..., 2]))
    q = torch.clamp(unit * 65536.0, 0.0, 65535.0).to(torch.int64)
    return (expand_bits_2(q[..., 0]) << 1 | expand_bits_2(q[..., 1])) & _M32


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count the leading zeros of x's low 32 bits: 32 less their bit
    length, the exponent ``frexp`` gives for the value as a float64 (exact
    below 2^53; 0 for 0). int64 values in [0, 32]."""
    _, exp = torch.frexp(_u32(x).to(torch.float64))
    return 32 - exp.to(torch.int64)
