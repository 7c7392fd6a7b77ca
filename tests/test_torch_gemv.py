"""The port's GEMV (``wgmath_tpu_torch.ops.gemv``) against the JAX package's
``wgmath_tpu.ops.gemv`` on the same seeded inputs: the Pallas kernels run in
interpret mode (as ``tests/test_ops.py`` runs them on the CPU) where they
take the shape, and the XLA twin everywhere, against the port's wrapper,
which on a CPU tensor runs the kernels' plain PyTorch version.

The CUDA kernels themselves are held against that plain version on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgmath_tpu.core import module as jax_module
from wgmath_tpu.ops.gemv import gemv as jax_gemv
from wgmath_tpu.ops.gemv import gemv_xla as jax_gemv_xla
from wgmath_tpu_torch.core.module import compile_check, compose, get_module
from wgmath_tpu_torch.core.testing import assert_close
from wgmath_tpu_torch.ops import gemv, gemv_torch, gemv_xla
from tests.torch_threads import one_torch_thread  # noqa: F401

gemv_mod = importlib.import_module("wgmath_tpu_torch.ops.gemv")

# f32 sums of <= 512 terms taken in another order, outputs of size ~1 (A is
# scaled by 1/sqrt(K)): a few 1e-7
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, a_shape, x_shape):
    rng = np.random.default_rng(seed)
    k = x_shape[-1]
    a = (rng.normal(size=a_shape) / np.sqrt(k)).astype(np.float32)
    return a, rng.normal(size=x_shape).astype(np.float32)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_gemv_matches_pallas_interpret_and_xla_aligned(transpose_a):
    a, x = _inputs(0, (512, 384), (512,) if transpose_a else (384,))
    got = gemv(torch.from_numpy(a), torch.from_numpy(x),
               transpose_a=transpose_a)
    assert got.shape == ((384,) if transpose_a else (512,))
    ja, jx = jnp.asarray(a), jnp.asarray(x)
    assert_close(got, jax_gemv(ja, jx, transpose_a=transpose_a,
                               impl="pallas"), **TOL)
    assert_close(got, jax_gemv_xla(ja, jx, transpose_a=transpose_a), **TOL)
    assert_close(gemv_xla(torch.from_numpy(a), torch.from_numpy(x),
                          transpose_a=transpose_a), got, **TOL)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("a_shape,x_shape,x_shape_tr", [
    ((500, 300), (300,), (500,)),  # ragged
    ((5, 64, 96), (96,), (64,)),  # batched, one x for the whole batch
    ((5, 64, 96), (5, 96), (5, 64)),  # batched x
    ((1, 300), (300,), (1,)),  # M = 1 / K = 1
    ((300, 1), (1,), (300,)),  # K = 1 / M = 1
])
def test_gemv_matches_jax_unaligned_and_batched(a_shape, x_shape, x_shape_tr,
                                                transpose_a):
    """Shapes the Pallas kernels do not take go to the XLA twin in the JAX
    package; the port's plain version takes them all."""
    a, x = _inputs(1, a_shape, x_shape_tr if transpose_a else x_shape)
    got = gemv(torch.from_numpy(a), torch.from_numpy(x),
               transpose_a=transpose_a)
    want = jax_gemv(jnp.asarray(a), jnp.asarray(x), transpose_a=transpose_a)
    assert got.shape == want.shape
    assert_close(got, want, **TOL)


def test_gemv_mismatch_raises_the_jax_message():
    a, x = torch.zeros((3, 4)), torch.zeros(5)
    with pytest.raises(ValueError) as ours:
        gemv(a, x)
    with pytest.raises(ValueError) as theirs:
        jax_gemv(jnp.zeros((3, 4)), jnp.zeros(5))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="mismatch"):
        gemv(a, torch.zeros(4), transpose_a=True)
    with pytest.raises(ValueError, match="impl"):
        gemv(a, torch.zeros(4), impl="pallas")


def test_gemv_cuda_impl_refuses_a_cpu_tensor_and_counts_nothing():
    before = (gemv_mod.LAUNCHES_GEMV, gemv_mod.LAUNCHES_GEMV_TR)
    with pytest.raises(ValueError, match="CUDA"):
        gemv(torch.zeros((4, 4)), torch.zeros(4), impl="cuda")
    gemv(torch.zeros((4, 4)), torch.zeros(4))
    gemv(torch.zeros((4, 4)), torch.zeros(4), transpose_a=True)
    assert (gemv_mod.LAUNCHES_GEMV, gemv_mod.LAUNCHES_GEMV_TR) == before


def test_gemv_module_matches_the_jax_registry():
    import wgmath_tpu.ops  # noqa: F401  (registers the JAX modules)

    ours, theirs = get_module("linalg.gemv"), jax_module.get_module(
        "linalg.gemv")
    assert list(ours.entries) == list(theirs.entries)
    assert list(ours.provides) == list(theirs.provides)
    assert ours.deps == theirs.deps
    assert list(compose("linalg.gemv")) == list(
        jax_module.compose("linalg.gemv"))
    assert compile_check("linalg.gemv", device="cpu") == ["gemv", "gemv_tr"]
    for name in ("gemv", "gemv_tr"):
        args = ours.entries[name].example_args(torch.device("cpu"))
        jargs = theirs.entries[name].example_args()
        assert [tuple(t.shape) for t in args] == [tuple(j.shape)
                                                   for j in jargs]


def test_gemv_chain_of_eight_matches_jax():
    """The bench's chain ``v <- gemv(A, v)`` at n = 256, eight steps, A
    scaled by 1/sqrt(n) as the bench scales it by 1/64 at 4096."""
    a, x = _inputs(2, (256, 256), (256,))
    ta, tv = torch.from_numpy(a), torch.from_numpy(x)
    ja, jv = jnp.asarray(a), jnp.asarray(x)
    for _ in range(8):
        tv = gemv(ta, tv)
        jv = jax_gemv(ja, jv, impl="pallas")
    assert_close(tv, jv, **TOL)
    assert_close(gemv_torch(ta, torch.from_numpy(x)),
                 a @ x, **TOL)
