"""The port's native joint colouring (``wgmath_tpu_torch.native``: the C++
``wg_greedy_color`` built by ``core/native_build.py``) against its plain
Python twin and the JAX package's ``joint._greedy_color`` (plain numpy),
exactly, on seeded joint graphs with invalid joints and static bodies, and
past the library's 64 colours, where the twin finishes the colouring
without a cap as the JAX package does."""

import os

import numpy as np
import pytest

from wgmath_tpu.dynamics.joint import _greedy_color as jax_greedy_color
from wgmath_tpu_torch.core import native_build
from wgmath_tpu_torch.native import greedy_color, greedy_color_plain
from tests.torch_threads import one_torch_thread  # noqa: F401


def _graph(seed: int, n_bodies: int, n_joints: int, static: int,
           invalid_share: float):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_bodies, n_joints)
    b = rng.integers(0, n_bodies - 1, n_joints)
    b = np.where(b >= a, b + 1, b)
    valid = rng.random(n_joints) >= invalid_share
    dynamic = np.arange(n_bodies) >= static
    return a.astype(np.int32), b.astype(np.int32), dynamic, valid


def _independent(colors, a, b, dynamic, valid):
    for c in np.unique(colors[valid]):
        m = valid & (colors == c)
        ends = np.concatenate([a[m][dynamic[a[m]]], b[m][dynamic[b[m]]]])
        assert len(ends) == len(np.unique(ends)), c


@pytest.mark.parametrize("seed,n_bodies,n_joints,static,invalid", [
    (0, 50, 200, 3, 0.1), (1, 400, 900, 10, 0.0), (2, 30, 300, 5, 0.3),
    (3, 12, 60, 0, 0.05)])
def test_greedy_color_matches_twin_and_jax(seed, n_bodies, n_joints, static,
                                           invalid):
    a, b, dynamic, valid = _graph(seed, n_bodies, n_joints, static, invalid)
    got = greedy_color(a, b, dynamic, valid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, greedy_color_plain(a, b, dynamic,
                                                          valid))
    np.testing.assert_array_equal(got, jax_greedy_color(a, b, valid,
                                                        dynamic))
    assert (got[~valid] == 0).all() and (got[valid] >= 1).all()
    _independent(got, a, b, dynamic, valid)


def test_star_past_64_colours():
    """65 joints on one dynamic hub need 65 colours: the library gives up
    at 64 and the twin colours the whole graph with no cap, as the JAX
    package does. A static hub needs one colour."""
    n = 65
    a = np.zeros(n, np.int32)
    b = np.arange(1, n + 1, dtype=np.int32)
    dynamic = np.ones(n + 1, bool)
    valid = np.ones(n, bool)
    got = greedy_color(a, b, dynamic, valid)
    np.testing.assert_array_equal(got, np.arange(1, n + 1))
    np.testing.assert_array_equal(got, jax_greedy_color(a, b, valid,
                                                        dynamic))
    dynamic[0] = False
    np.testing.assert_array_equal(greedy_color(a, b, dynamic, valid),
                                  np.ones(n, np.int32))


def test_library_built_from_the_port_copy():
    """The library is the port's own build of its copy of the source, in
    the port's build directory; the default ``valid`` is every joint."""
    path = native_build.target()
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert os.path.basename(path).startswith("wgnative-")
    assert "wgmath_tpu_torch" in native_build.SOURCE
    greedy_color([0], [1], np.ones(2, bool))
    assert os.path.exists(path)
    np.testing.assert_array_equal(greedy_color([0, 1], [1, 2],
                                               np.ones(3, bool)), [1, 2])


def test_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output:
    no quiet fallback."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SOURCE", str(bad))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build()
