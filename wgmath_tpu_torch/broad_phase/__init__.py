"""Broad phases (counterpart of ``wgmath_tpu/broad_phase``, with the same
names)."""

from wgmath_tpu_torch.broad_phase.brute_force import (  # noqa: F401
    PairList,
    find_pairs,
)
