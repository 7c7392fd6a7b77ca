"""The port's core runtime (``wgmath_tpu_torch.core``): module registry and
strided views, mirroring ``tests/test_core.py`` and held against the JAX
package's registry and ``View`` on the same modules and buffers."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgmath_tpu.core import View as JaxView
from wgmath_tpu.core import view_of as jax_view_of
from wgmath_tpu.core import module as jax_module
from wgmath_tpu_torch.core import (
    KernelModule,
    View,
    all_modules,
    compose,
    flat_source,
    get_module,
    view_of,
)
from wgmath_tpu_torch.core import cuda_build
from wgmath_tpu_torch.core import module as module_mod
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    compile_check,
    dependency_order,
    needs_reload,
    register_module,
    reload,
    watch_sources,
)
from wgmath_tpu_torch.core.testing import assert_close

import wgmath_tpu_torch.ops  # noqa: F401  (registers the linalg modules)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _diamond(register, module_cls, entry_cls, example):
    """base <- left, base <- right, top <- (left, right), on either
    package's registry."""
    def base_fn(x):
        return x + 1.0

    def left_fn(x):
        return base_fn(x) * 2.0

    def right_fn(x):
        return base_fn(x) * 3.0

    def top_fn(x):
        return left_fn(x) + right_fn(x)

    register(module_cls("t_base", provides={"base_fn": base_fn}))
    register(module_cls("t_left", deps=("t_base",),
                        provides={"left_fn": left_fn}))
    register(module_cls("t_right", deps=("t_base",),
                        provides={"right_fn": right_fn}))
    register(module_cls(
        "t_top", deps=("t_left", "t_right"), provides={"top_fn": top_fn},
        entries={"top": entry_cls(fn=top_fn, example_args=example)}))


def _make_diamond():
    _diamond(register_module, KernelModule, EntryPoint,
             lambda device: (torch.zeros((8,), device=device),))


@pytest.fixture
def jax_registry_restored():
    """The JAX package's registry as it was before the test: the diamond's
    names belong to ``tests/test_core.py`` there, which may run later on
    the same worker."""
    registry = dict(jax_module._REGISTRY)
    defining = dict(jax_module._DEFINING_PYMODULE)
    yield
    jax_module._REGISTRY.clear()
    jax_module._REGISTRY.update(registry)
    jax_module._DEFINING_PYMODULE.clear()
    jax_module._DEFINING_PYMODULE.update(defining)


def test_module_diamond_dedup_and_compose_match_jax(jax_registry_restored):
    _make_diamond()
    _diamond(functools.partial(jax_module.register_module,
                               allow_replace=True),
             jax_module.KernelModule, jax_module.EntryPoint,
             lambda: (jnp.zeros((8,), jnp.float32),))
    order = dependency_order("t_top")
    assert order == jax_module.dependency_order("t_top")
    assert order.count("t_base") == 1
    assert order[0] == "t_base" and order[-1] == "t_top"
    ns = compose("t_top")
    assert list(ns) == list(jax_module.compose("t_top"))
    assert set(ns) >= {"base_fn", "left_fn", "right_fn", "top_fn"}
    out = ns["top_fn"](torch.tensor(1.0))
    assert float(out) == (1.0 + 1) * 2 + (1.0 + 1) * 3
    assert float(out) == float(
        jax_module.compose("t_top")["top_fn"](jnp.float32(1.0)))


def test_module_duplicate_registration_rejected():
    register_module(KernelModule("t_dup", provides={}))
    # the same defining module may register again (importlib.reload)
    register_module(KernelModule("t_dup", provides={"f": abs}))
    assert "f" in get_module("t_dup").provides
    module_mod._DEFINING_PYMODULE["t_dup"] = "somewhere.else"
    with pytest.raises(ValueError, match="already registered"):
        register_module(KernelModule("t_dup", provides={}))
    replaced = register_module(KernelModule("t_dup", provides={}),
                               allow_replace=True)
    assert get_module("t_dup") is replaced
    assert module_mod._DEFINING_PYMODULE["t_dup"] == __name__


def test_unknown_module_names_the_registered_ones():
    with pytest.raises(KeyError, match="linalg.gemm"):
        get_module("no.such.module")
    assert {"linalg.gemm", "linalg.reduce",
            "linalg.op_assign"} <= set(all_modules())


def test_flat_source_and_compile_check():
    _make_diamond()
    src = flat_source("t_top")
    assert "module: t_base" in src and "base_fn" in src
    assert src.index("module: t_base") < src.index("module: t_top")
    assert src.count("def base_fn") == 1  # the diamond's base appears once
    assert compile_check("t_top", device="cpu") == ["top"]
    assert compile_check("t_top", entry="top", device="cpu") == ["top"]
    assert "def gemm(" in flat_source("linalg.gemm")


def test_compile_check_runs_entries_and_skips_those_without_examples():
    calls = []
    register_module(KernelModule("t_entries", entries={
        "runs": EntryPoint(fn=lambda x: calls.append(x.device.type),
                           example_args=lambda device: (
                               torch.ones(2, device=device),)),
        "no_example": EntryPoint(fn=lambda: calls.append("never")),
        "fails": EntryPoint(fn=lambda x: x @ x,
                            example_args=lambda device: (
                                torch.ones((2, 3), device=device),)),
    }))
    assert compile_check("t_entries", entry="runs", device="cpu") == ["runs"]
    assert calls == ["cpu"]
    with pytest.raises(RuntimeError):
        compile_check("t_entries", device="cpu")


@pytest.mark.parametrize("mod", ["linalg.gemm", "linalg.reduce",
                                 "linalg.op_assign"])
def test_linalg_modules_match_the_jax_registry(mod):
    """Same entry points under the same names; the provided functions agree
    except for the library twin's name (``gemm_torch`` for ``gemm_xla``)."""
    import wgmath_tpu.ops  # noqa: F401

    ours, theirs = get_module(mod), jax_module.get_module(mod)
    assert list(ours.entries) == list(theirs.entries)
    assert ours.deps == theirs.deps
    rename = {"gemm_xla": "gemm_torch"}
    assert list(ours.provides) == [rename.get(k, k) for k in theirs.provides]
    assert compile_check(mod, device="cpu") == list(ours.entries)


def test_reload_reimports_and_drops_kernel_handles():
    before = get_module("linalg.reduce")
    cuda_build._LIBS["t_stale"] = object()
    stamps = watch_sources(["linalg.reduce", "linalg.gemm"])
    assert set(stamps) == {"linalg.reduce", "linalg.gemm"}
    assert needs_reload(stamps) == []
    # as if the file had been edited since the snapshot
    stamps["linalg.reduce"] -= 10.0
    assert needs_reload(stamps) == ["linalg.reduce"]
    after = reload("linalg.reduce")
    assert after is not before and after is get_module("linalg.reduce")
    assert list(after.entries) == list(before.entries)
    assert "t_stale" not in cuda_build._LIBS
    with pytest.raises(KeyError):
        reload("no.such.module")


def _views(x):
    return view_of(torch.from_numpy(x)), jax_view_of(jnp.asarray(x))


def _same(tv: View, jv: JaxView):
    assert (tv.shape, tv.stride, tv.stride_mat, tv.offset) == \
        (jv.shape, jv.stride, jv.stride_mat, jv.offset)
    np.testing.assert_array_equal(tv.buffer.numpy(), np.asarray(jv.buffer))
    np.testing.assert_array_equal(tv.to_array().numpy(),
                                  np.asarray(jv.to_array()))


def test_view_roundtrip_matrix_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    v, jv = _views(a)
    _same(v, jv)
    assert_close(v.to_matrix(), a, rtol=0)
    assert_close(v.column(2).to_vector(), a[:, 2], rtol=0)
    assert_close(v.rows(1, 3).columns(1, 2).to_matrix(), a[1:4, 1:3], rtol=0)
    _same(v.column(2), jv.column(2))
    _same(v.rows(1, 3).columns(1, 2), jv.rows(1, 3).columns(1, 2))
    assert v.is_contiguous() and not v.rows(1, 3).is_contiguous()
    vec, jvec = _views(a[0])
    _same(vec, jvec)
    assert_close(vec.to_vector(), a[0], rtol=0)


def test_view_batched_and_reshape_match_jax():
    rng = np.random.default_rng(1)
    cube = rng.normal(size=(4, 3, 8)).astype(np.float32)  # [mat, col, row]
    v, jv = _views(cube)
    assert v.shape == (8, 3, 4)
    _same(v, jv)
    _same(v.matrix(2), jv.matrix(2))
    assert_close(v.matrix(2).to_matrix(), cube[2].T, rtol=0)
    flat, jflat = _views(cube.reshape(-1))
    r = flat.reshape(8, 12)
    _same(r, jflat.reshape(8, 12))
    assert r.to_matrix().shape == (8, 12)
    _same(flat.reshape(8, 3, 4), v)


def test_view_errors_match_jax():
    v, jv = _views(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    for call in (lambda w: w.reshape(5, 5),
                 lambda w: w.rows(1, 2).reshape(6, 2),
                 lambda w: w.to_matrix(), lambda w: w.to_vector()):
        with pytest.raises(ValueError) as jax_err:
            call(jv)
        with pytest.raises(ValueError) as err:
            call(v)
        assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="rank 4"):
        view_of(torch.zeros((1, 1, 1, 1)))
