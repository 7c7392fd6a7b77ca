"""Geometric types and small-matrix decompositions (counterpart of
``wgmath_tpu/geometry/__init__.py``, with the same names)."""

from wgmath_tpu_torch.geometry import quat, rot2  # noqa: F401
from wgmath_tpu_torch.geometry.sim import Sim  # noqa: F401
from wgmath_tpu_torch.geometry import sim  # noqa: F401
from wgmath_tpu_torch.geometry.inv import (  # noqa: F401
    det2,
    det3,
    det4,
    inv,
    inv2,
    inv3,
    inv4,
)
from wgmath_tpu_torch.geometry.decomp import (  # noqa: F401
    cholesky,
    cholesky_solve,
    lu,
    lu_solve,
    lu_unpack,
    qr,
    svd,
    symmetric_eigen,
)
from wgmath_tpu_torch.geometry.utils import stable_atan2, stable_atanh  # noqa: F401
