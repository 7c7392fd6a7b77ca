"""The port's linear-algebra layer (``wgmath_tpu_torch.ops``) against the JAX
package's ``wgmath_tpu.ops`` on the same seeded inputs: each Pallas kernel
run in interpret mode (as ``tests/test_ops.py`` runs it on the CPU) and its
XLA twin, against the port's wrapper, which on a CPU tensor runs the
kernel's plain PyTorch version.

The CUDA and Triton kernels themselves are held against those plain
versions on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgmath_tpu.core.module import compose as jax_compose
from wgmath_tpu.ops import eval_cpu as jax_eval_cpu
from wgmath_tpu.ops import gemm as jax_gemm
from wgmath_tpu.ops import gemm_xla as jax_gemm_xla
from wgmath_tpu.ops import op_assign as jax_op_assign
from wgmath_tpu.ops import op_assign_pallas as jax_op_assign_pallas
from wgmath_tpu.ops import reduce as jax_reduce
from wgmath_tpu.ops.gemm import _split3 as jax_split3
from wgmath_tpu.ops.gemm import gemm_split as jax_gemm_split
from wgmath_tpu_torch.core.module import compile_check, compose
from wgmath_tpu_torch.core.testing import assert_close
from wgmath_tpu_torch.ops import (
    VARIANTS,
    eval_cpu,
    gemm,
    gemm_torch,
    op_assign,
    op_assign_kernel,
    reduce,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

# the ops package re-exports functions under its submodules' names
gemm_mod = importlib.import_module("wgmath_tpu_torch.ops.gemm")
reduce_mod = importlib.import_module("wgmath_tpu_torch.ops.reduce")
elementwise_mod = importlib.import_module("wgmath_tpu_torch.ops.elementwise")

# The reference's golden tolerance for GEMM-class kernels (wgebra
# gemm.rs:199-202), which the JAX package's own tests use.
GOLDEN = dict(rtol=1e-3, atol=1e-3)
# Both sides in f32 on one CPU, sums over <= 512 terms of size ~1 taken in
# another order: a few 1e-5 absolute on entries of size ~20.
F32_SUMS = dict(rtol=1e-5, atol=1e-4)
# Elementwise f32: both sides round each result once.
EXACT = dict(rtol=1e-6, atol=0.0)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


# --- GEMM --------------------------------------------------------------------
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gemm_variants_match_jax_256(rng, ta, tb):
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=(256, 256)).astype(np.float32)
    got = gemm(_t(a), _t(b), transpose_a=ta, transpose_b=tb)
    want = jax_gemm_xla(jnp.asarray(a), jnp.asarray(b), transpose_a=ta,
                        transpose_b=tb, precision=jax.lax.Precision.HIGHEST)
    assert_close(got, want, **F32_SUMS)
    assert_close(got, (a.T if ta else a) @ (b.T if tb else b), **GOLDEN)


def test_gemm_matches_pallas_interpret_aligned(rng):
    a = rng.normal(size=(2, 256, 512)).astype(np.float32)
    b = rng.normal(size=(2, 512, 128)).astype(np.float32)
    want = jax_gemm(jnp.asarray(a), jnp.asarray(b), impl="pallas")
    got = gemm(_t(a), _t(b))
    assert got.shape == (2, 256, 128) and got.dtype == torch.float32
    assert_close(got, want, **F32_SUMS)


def test_gemm_matches_pallas_interpret_transpose_a(rng):
    a = rng.normal(size=(1, 512, 256)).astype(np.float32)
    b = rng.normal(size=(1, 512, 128)).astype(np.float32)
    want = jax_gemm(jnp.asarray(a), jnp.asarray(b), transpose_a=True,
                    impl="pallas")
    assert_close(gemm(_t(a), _t(b), transpose_a=True), want, **F32_SUMS)


def test_gemm_batched_unaligned_matches_jax(rng):
    a = rng.normal(size=(3, 64, 100)).astype(np.float32)
    b = rng.normal(size=(3, 100, 48)).astype(np.float32)
    want = jax_gemm(jnp.asarray(a), jnp.asarray(b))
    assert_close(gemm(_t(a), _t(b)), want, **F32_SUMS)
    assert_close(gemm(_t(a), _t(b)), a @ b, **GOLDEN)


def test_gemm_broadcasts_a_single_matrix_operand(rng):
    a = rng.normal(size=(3, 64, 100)).astype(np.float32)
    b = rng.normal(size=(100, 48)).astype(np.float32)
    want = jax_gemm_xla(jnp.asarray(a), jnp.asarray(b),
                        precision=jax.lax.Precision.HIGHEST)
    got = gemm(_t(a), _t(b))
    assert got.shape == (3, 64, 48)
    assert_close(got, want, **F32_SUMS)
    got_t = gemm(_t(b), _t(a), transpose_a=True, transpose_b=True)
    assert got_t.shape == (3, 48, 64)
    assert_close(got_t, np.swapaxes(a @ b, -1, -2), **F32_SUMS)


def test_gemm_bf16_matches_jax(rng):
    """bf16 in, f32 accumulation, bf16 out rounded once: the two sides may
    round a sum taken in another order to neighbouring bf16 values (one bf16
    ulp is 2^-7 of the value)."""
    a = jnp.asarray(rng.normal(size=(2, 128, 256)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(2, 256, 128)) / 16.0, jnp.bfloat16)
    want = jax_gemm(a, b, impl="pallas")
    ta = _t(np.asarray(a, np.float32)).bfloat16()
    tb = _t(np.asarray(b, np.float32)).bfloat16()
    got = gemm(ta, tb)
    assert got.dtype == torch.bfloat16
    assert_close(got, np.asarray(want, np.float32), rtol=1.6e-2, atol=1e-2)


def test_gemm_precisions_and_impl_names(rng):
    a = _t(rng.normal(size=(32, 48)).astype(np.float32))
    b = _t(rng.normal(size=(48, 16)).astype(np.float32))
    want = gemm_torch(a, b)
    for prec in ("default", "high", "highest"):
        assert torch.equal(gemm(a, b, precision=prec), want)
    assert torch.equal(gemm(a, b, impl="torch"), want)
    with pytest.raises(ValueError, match="precision"):
        gemm(a, b, precision="exact")
    with pytest.raises(ValueError, match="impl"):
        gemm(a, b, impl="pallas")
    # "cuda" never gives way to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        gemm(a, b, impl="cuda")
    # mixed types go to the plain route in the promoted type, as in JAX
    assert gemm(a, b.double()).dtype == torch.float64
    # a tensor is never moved for the caller
    with pytest.raises(ValueError, match="different devices"):
        gemm(a, b.to("meta"))


def test_gemm_rank_and_inner_dimension_errors(rng):
    a = _t(rng.normal(size=(8, 6)).astype(np.float32))
    for ja, jb in ((jnp.ones((6,)), jnp.ones((6, 4))),
                   (jnp.ones((8, 6)), jnp.ones((5, 4)))):
        with pytest.raises(ValueError) as jax_err:
            jax_gemm(ja, jb)
        with pytest.raises(ValueError) as err:
            gemm(_t(np.asarray(ja)), _t(np.asarray(jb)))
        assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="inner dims mismatch: 8 vs 6"):
        gemm(a, a, transpose_a=True, transpose_b=True)


# --- the gemm kernel's 3 x TF32 arithmetic, in plain PyTorch -----------------
def _tf32_values():
    """Seeded f32 values over many binades, with exact ties at the TF32
    rounding bit, subnormals and both zeros."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=4096) * 2.0 ** rng.integers(-60, 60, size=4096))
    bits = x.astype(np.float32).view(np.int32)
    ties = (bits[:512] & ~0x1FFF) | 0x1000  # exactly half a TF32 ulp
    sub = rng.integers(1, 1 << 23, size=256).astype(np.int32)  # subnormals
    sub[::2] |= np.int32(-(1 << 31))
    special = np.array([0.0, -0.0, 1e-30, -3e38], np.float32).view(np.int32)
    return torch.from_numpy(np.concatenate([bits, ties, sub, special])
                            .view(np.float32))


def test_tf32_split_is_exact_and_keeps_22_bits():
    x = _tf32_values()
    big = gemm_mod._round_tf32(x)
    rest = x - big
    # the subtraction is exact: big + (x - big) gives x back bit for bit
    # (-0.0 comes back as +0.0: -0.0 - -0.0 is +0.0)
    back = (big + rest).view(torch.int32)
    nz = x != 0
    assert torch.equal(back[nz], x.view(torch.int32)[nz])
    assert bool((back[~nz] == 0).all())
    small = gemm_mod._round_tf32(rest)
    for part in (big, small):  # at most 11 significant bits each
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # small's own rounding drops at most 2^-11 of rest, itself at most
    # 2^-11 of x; in the subnormal range the TF32 step is 2^-136
    err = (x.double() - (big.double() + small.double())).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs() + 2.0 ** -137).all())


def test_round_tf32_rounds_ties_away_from_zero():
    """Hand-picked values with what ``cvt.rna.tf32.f32`` gives: to nearest,
    a tie away from zero (where round-to-even would differ)."""
    one_ulp, half_ulp = 2.0 ** -10, 2.0 ** -11
    cases = [(1.0 + half_ulp, 1.0 + one_ulp),  # tie: even would give 1.0
             (-(1.0 + half_ulp), -(1.0 + one_ulp)),
             (1.0 + half_ulp - 2.0 ** -23, 1.0),  # just below the tie
             (1.0 + 3 * half_ulp, 1.0 + 2 * one_ulp),
             (2.0 - half_ulp, 2.0),  # the tie carries into the exponent
             (0.0, 0.0), (-0.0, -0.0)]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    got = gemm_mod._round_tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # a subnormal tie: bit 12 set alone rounds up to bit 13
    sub = torch.tensor([0x1000, 0x0FFF], dtype=torch.int32).view(
        torch.float32)
    assert gemm_mod._round_tf32(sub).view(torch.int32).tolist() == [0x2000,
                                                                    0]


def test_gemm_3xtf32_matches_jax_highest_and_f64_256(rng):
    """The kernel's f32 arithmetic against the JAX package's full-precision
    library route: f32 sums of 256 terms in another order (F32_SUMS). Against
    f64 within 1e-5 of the mean magnitude: each product keeps 2^-21 of its
    value, the sums are f32. One TF32 pass alone is ~100x further off."""
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=(256, 256)).astype(np.float32)
    got = gemm_mod._gemm_3xtf32_torch(_t(a), _t(b))
    want = jax_gemm(jnp.asarray(a), jnp.asarray(b), precision="highest",
                    impl="xla")
    assert got.dtype == torch.float32
    assert_close(got, want, **F32_SUMS)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).mean()
    assert np.abs(got.double().numpy() - ref).max() / scale < 1e-5
    one_pass = gemm_mod._round_tf32(_t(a)) @ gemm_mod._round_tf32(_t(b))
    assert np.abs(one_pass.double().numpy() - ref).max() / scale > 1e-4


# --- gemm_split --------------------------------------------------------------
def test_split3_planes_bitwise_equal_to_jax_and_exact():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, 256)).astype(np.float32)
    a[0, :4] = [0.0, -0.0, 1e-30, 3e38]
    want = np.asarray(jax.jit(jax_split3)(jnp.asarray(a)), np.float32)
    got = gemm_mod._split3(_t(a))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 256, 256)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy().sum(0), a)


@pytest.mark.parametrize("n_passes,f64_tol", [(6, 5e-6), (3, 1e-3)])
def test_gemm_split_matches_jax_and_f64(n_passes, f64_tol):
    """Against the Pallas kernel in interpret mode (f32 sums of exact bf16
    products in another order: 1e-5 of entries of size ~1), and against the
    f64 product within the JAX package's own limits (tests/test_ops.py)."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = (rng.normal(size=(256, 256)) / 16).astype(np.float32)
    want = np.asarray(jax_gemm_split(jnp.asarray(a), jnp.asarray(b),
                                     n_passes=n_passes, bm=256, bn=256,
                                     bk=256))
    got = gemm_mod.gemm_split(_t(a), _t(b), n_passes=n_passes)
    assert got.dtype == torch.float32
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got.double().numpy() - ref).max() / np.abs(ref).mean() \
        < f64_tol


def test_gemm_split_ragged_shape_and_errors():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(33, 70)).astype(np.float32)
    b = rng.normal(size=(70, 17)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = gemm_mod.gemm_split(_t(a), _t(b))
    assert np.abs(got.double().numpy() - ref).max() / np.abs(ref).mean() \
        < 5e-6
    with pytest.raises(ValueError, match="n_passes"):
        gemm_mod.gemm_split(_t(a), _t(b), n_passes=4)
    with pytest.raises(ValueError, match="2-D float32"):
        gemm_mod.gemm_split(_t(a)[None], _t(b))
    with pytest.raises(ValueError, match="2-D float32"):
        gemm_mod.gemm_split(_t(a).double(), _t(b).double())
    with pytest.raises(ValueError, match="inner dims"):
        gemm_mod.gemm_split(_t(a), _t(a))


# --- reduce ------------------------------------------------------------------
@pytest.mark.parametrize("op", ["sum", "min", "max", "sqnorm", "prod"])
def test_reduce_matches_pallas_interpret_8192(op):
    """8,192 terms of size ~1 added (or multiplied) in another order: 1e-4
    of the result for the sums, 5e-3 for the product as in
    tests/test_ops.py; min and max exact."""
    rng = np.random.default_rng(11)
    x = (rng.uniform(0.9, 1.1, size=8192) if op == "prod"
         else rng.normal(size=8192)).astype(np.float32)
    want = float(jax_reduce(jnp.asarray(x), op, impl="pallas"))
    got = reduce(_t(x), op)
    assert got.shape == () and got.dtype == torch.float32
    rtol = {"prod": 5e-3, "min": 0.0, "max": 0.0}.get(op, 1e-4)
    assert_close(got, want, rtol=rtol, atol=1e-3 if rtol else 0.0)
    assert_close(got, jax_eval_cpu(x, op), rtol=max(rtol, 1e-6), atol=1e-3)


@pytest.mark.parametrize("n", [4096, 1237])
@pytest.mark.parametrize("op", ["sum", "min", "max", "sqnorm", "prod"])
def test_reduce_matches_jax_and_oracle(op, n):
    rng = np.random.default_rng(n)
    x = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    want = float(jax_reduce(jnp.asarray(x), op))
    rtol = 5e-3 if op == "prod" else 1e-3  # the JAX package's own
    got = reduce(_t(x), op)
    assert_close(got, want, rtol=rtol)
    assert_close(got, eval_cpu(x, op), rtol=rtol)
    assert eval_cpu(x, op) == jax_eval_cpu(x, op)
    # any shape reduces through its flattened form
    assert_close(reduce(_t(x.reshape(1, n)), op), want, rtol=rtol)


def test_reduce_nan_names_and_impls():
    x = _t(np.array([1.0, np.nan, -2.0], np.float32))
    assert torch.isnan(reduce(x, "min")) and torch.isnan(reduce(x, "max"))
    assert float(reduce(x[:0], "prod")) == 1.0
    assert float(reduce(x[:0], "min")) == np.inf
    assert float(reduce(_t(np.arange(5)), "sum")) == 10  # integers: plain
    with pytest.raises(KeyError):
        reduce(x, "mean")
    with pytest.raises(ValueError, match="impl"):
        reduce(x, "sum", impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        reduce(x, "sum", impl="cuda")
    assert float(reduce(x[2:], "sum", impl="torch")) == -2.0


# --- op_assign ---------------------------------------------------------------
@pytest.mark.parametrize("op", sorted(VARIANTS))
def test_op_assign_variants_match_jax(rng, op):
    a = rng.normal(size=(33, 77)).astype(np.float32)
    b = rng.normal(size=(33, 77)).astype(np.float32) + 2.0
    want = jax_op_assign(jnp.asarray(a), jnp.asarray(b), op)
    assert_close(op_assign(_t(a), _t(b), op), want, **EXACT)
    a2, b2 = a[:, :64].copy(), b[:, :64].copy()
    want_k = jax_op_assign_pallas(jnp.asarray(a2), jnp.asarray(b2), op)
    got_k = op_assign_kernel(_t(a2), _t(b2), op)
    assert got_k.shape == (33, 64) and got_k.dtype == torch.float32
    assert_close(got_k, want_k, **EXACT)


def test_op_assign_callable_redirect_matches_jax(rng):
    a = rng.normal(size=(16, 128)).astype(np.float32)
    b = rng.normal(size=(16, 128)).astype(np.float32)

    def fn(x, y):
        return x * 2 + y

    want = jax_op_assign_pallas(jnp.asarray(a), jnp.asarray(b), fn)
    assert_close(op_assign(_t(a), _t(b), fn), want, **EXACT)
    assert_close(op_assign_kernel(_t(a), _t(b), fn), want, **EXACT)
    assert_close(jax_op_assign(jnp.asarray(a), jnp.asarray(b), op=fn), want,
                 **EXACT)


def test_op_assign_kernel_errors(rng):
    a = _t(rng.normal(size=(4, 4)).astype(np.float32))
    with pytest.raises(KeyError):
        op_assign_kernel(a, a, "pow")
    with pytest.raises(ValueError, match="shapes differ"):
        op_assign_kernel(a, a[:2], "add")
    with pytest.raises(TypeError):
        op_assign_kernel(a, a, 3)


# --- registry entries and the slice as a whole -----------------------------
@pytest.mark.parametrize("mod,entries", [
    ("linalg.gemm", ["gemm", "gemm_tr"]),
    ("linalg.reduce", ["sum", "prod", "min", "max", "sqnorm"]),
    ("linalg.op_assign", ["add", "sub", "mul", "div", "copy"]),
])
def test_linalg_modules_compile_check_on_cpu(mod, entries):
    assert compile_check(mod, device="cpu") == entries


def test_cpu_tensors_launch_no_kernel(rng):
    a = _t(rng.normal(size=(16, 16)).astype(np.float32))
    before = (gemm_mod.LAUNCHES_GEMM, gemm_mod.LAUNCHES_GEMM_SPLIT,
              reduce_mod.LAUNCHES_REDUCE, elementwise_mod.LAUNCHES_OP_ASSIGN)
    gemm(a, a)
    gemm_mod.gemm_split(a, a)
    reduce(a, "sum")
    op_assign_kernel(a, a, "add")
    assert before == (gemm_mod.LAUNCHES_GEMM, gemm_mod.LAUNCHES_GEMM_SPLIT,
                      reduce_mod.LAUNCHES_REDUCE,
                      elementwise_mod.LAUNCHES_OP_ASSIGN)


def test_composition_graph_three_iterations_match_jax():
    """The bench's GEMM -> sqnorm -> normalize graph through ``compose`` on
    both sides, three chained iterations at n = 256. Each iteration
    normalizes to unit Frobenius norm (entries ~4e-3); both sides are f32 on
    one CPU with sums in another order, so 1e-4 of an entry's size."""
    n = 256
    rng = np.random.default_rng(2)
    a = rng.normal(size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)

    jns = {}
    jns.update(jax_compose("linalg.gemm"))
    jns.update(jax_compose("linalg.reduce"))
    jc, jb = jnp.asarray(a), jnp.asarray(b)
    for _ in range(3):
        jc = jns["gemm"](jc, jb, precision="default")
        js = jns["reduce"](jc.reshape(-1), "sqnorm")
        jc = jc * jax.lax.rsqrt(js + 1e-12)

    tns = {}
    tns.update(compose("linalg.gemm"))
    tns.update(compose("linalg.reduce"))
    tc, tb = _t(a), _t(b)
    for _ in range(3):
        tc = tns["gemm"](tc, tb, precision="default")
        ts = tns["reduce"](tc.reshape(-1), "sqnorm")
        tc = tc * torch.rsqrt(ts + 1e-12)

    assert torch.isfinite(tc).all()
    assert float(reduce(tc.reshape(-1), "sqnorm")) == pytest.approx(1.0,
                                                                    abs=1e-5)
    assert_close(tc, jc, rtol=1e-4, atol=4e-7)
