"""Geometric queries (counterpart of ``wgmath_tpu/queries``, with the same
names)."""

from wgmath_tpu_torch.queries.narrow_phase import (  # noqa: F401
    narrow_phase,
    ball_ball,
    ball_cuboid,
)
