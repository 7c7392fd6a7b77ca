"""The port's LBVH broad phase and the pieces under it against the JAX
package, exactly, on the same seeded inputs: Morton codes and the bit
utilities, the tree (``left`` / ``right`` / ``order`` and every node box),
the LBVH pair list and its count (past ``capacity`` and past the per-leaf
window too), the brute force's row blocks (``find_pairs_partial``), the
grid's ``active`` and row-block keywords, and the scan / sort utilities.
Each JAX function is one jitted call per input shape; the JAX package's
uint32 values are compared with the port's int64 ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgmath_tpu.broad_phase import brute_force as jbrute
from wgmath_tpu.broad_phase import grid as jgrid
from wgmath_tpu.broad_phase import lbvh as jlbvh
from wgmath_tpu.broad_phase import morton as jmorton
from wgmath_tpu.utils import scan_sort as jscan
from wgmath_tpu_torch.broad_phase import brute_force, grid, lbvh, morton
from wgmath_tpu_torch.utils import scan_sort
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got: torch.Tensor, want, what=""):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64)
                                  if np.asarray(want).dtype.kind in "iub"
                                  else np.asarray(want), what)


def test_bit_utilities_match_jax():
    rng = np.random.default_rng(0)
    edge = [0, 1, 2, 3, 255, 256, 1023, 1024, 2**16 - 1, 2**16, 2**30,
            2**31, 2**32 - 1]
    x = np.concatenate([edge, rng.integers(0, 2**32, 4000)]).astype(np.uint32)
    for name in ("expand_bits_3", "expand_bits_2", "clz32"):
        want = getattr(jmorton, name)(jnp.asarray(x))
        got = getattr(morton, name)(_t(x.astype(np.int64)))
        _eq(got, want, name)


def _lattice(n, seed=1):
    """Boxes on a coarse lattice, every centre twice: many equal codes."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil((n / 2) ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:(n + 1) // 2]
    c = np.repeat(g * 1.0, 2, axis=0)[:n].astype(np.float32)
    he = np.full((n, 3), 0.55, np.float32)
    perm = rng.permutation(n)
    return c[perm] - he[perm], c[perm] + he[perm]


def _random(n, seed, spread=5.0, lo=0.1, hi=0.9):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    he = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return c - he, c + he


@pytest.mark.parametrize("case", ["random3", "random2", "lattice"])
def test_morton_codes_match_jax(case):
    rng = np.random.default_rng(3)
    if case == "lattice":
        mn, mx = _lattice(400)
        pts = 0.5 * (mn + mx)
    else:
        dim = int(case[-1])
        pts = rng.uniform(-7.0, 3.0, (3000, dim)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    want = jmorton.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                jnp.asarray(hi))
    got = morton.morton_codes(_t(pts), _t(lo), _t(hi))
    _eq(got, want)
    if case == "lattice":
        assert len(np.unique(got.numpy())) < 400  # equal codes present


@pytest.mark.parametrize("case", ["n2", "n3", "n64", "n500", "lattice500"])
def test_build_matches_jax(case):
    if case == "lattice500":
        mn, mx = _lattice(500)
    else:
        n = int(case[1:])
        mn, mx = _random(n, n, spread=10.0, hi=1.0)
    want = jlbvh.build(jnp.asarray(mn), jnp.asarray(mx))
    got = lbvh.build(_t(mn), _t(mx))
    for f in ("left", "right", "order", "node_min", "node_max"):
        _eq(getattr(got, f), getattr(want, f), f)


def _pair_cases():
    mn, mx = _random(300, 300)
    lat = _lattice(300)
    # a dense cluster: 80 boxes over each other, each overlapping 79 more
    # than the per-leaf window of 64
    cmn, cmx = _random(300, 7)
    cmn[:80], cmx[:80] = cmn[:80] * 0.0 - 1.0, cmx[:80] * 0.0 + 1.0
    return {"random": (mn, mx, 8192), "lattice": (*lat, 8192),
            "per_leaf_cap": (cmn, cmx, 8192), "capacity": (mn, mx, 64)}


@pytest.mark.parametrize("case", ["random", "lattice", "per_leaf_cap",
                                  "capacity"])
def test_find_pairs_lbvh_matches_jax(case):
    mn, mx, cap = _pair_cases()[case]
    want = jlbvh.find_pairs_lbvh(jnp.asarray(mn), jnp.asarray(mx),
                                 capacity=cap)
    got = lbvh.find_pairs_lbvh(_t(mn), _t(mx), capacity=cap)
    for f in ("body_a", "body_b", "valid", "count"):
        _eq(getattr(got, f), getattr(want, f), f)
    true = {(int(i), int(j)) for i in range(len(mn)) for j in np.nonzero(
        np.all((mn[i] <= mx) & (mn <= mx[i]), -1))[0] if j > i}
    pairs = {(int(a), int(b)) for a, b in zip(got.body_a[got.valid].tolist(),
                                              got.body_b[got.valid].tolist())}
    count = int(got.count)
    if case in ("random", "lattice"):
        assert pairs == true and count == len(true)
    elif case == "capacity":
        assert len(pairs) == cap and pairs < true and count == len(true)
    else:
        # the windows drop pairs, and the count says so past the capacity
        assert pairs < true and count == max(len(true), cap + 1)


def _partial_inputs():
    mn, mx = _random(200, 11, spread=3.0)
    rad = np.where(np.arange(200) % 3 == 0, np.nan, 0.6).astype(np.float32)
    dyn = np.arange(200) % 5 != 0
    return mn, mx, rad, dyn


@pytest.mark.parametrize("block", [(0, 96), (96, 104)])
def test_find_pairs_partial_matches_jax(block):
    mn, mx, rad, dyn = _partial_inputs()
    r0, r = block
    sl = slice(r0, r0 + r)
    kw = dict(capacity=1024, block=64, max_per_row=32, margin=0.01)
    want = jbrute.find_pairs_partial(
        jnp.asarray(mn[sl]), jnp.asarray(mx[sl]), r0, jnp.asarray(mn),
        jnp.asarray(mx), ball_radius=jnp.asarray(rad),
        row_ball_radius=jnp.asarray(rad[sl]), dynamic=jnp.asarray(dyn),
        row_dynamic=jnp.asarray(dyn[sl]), **kw)
    got = brute_force.find_pairs_partial(
        _t(mn[sl]), _t(mx[sl]), torch.tensor(r0), _t(mn), _t(mx),
        ball_radius=_t(rad), row_ball_radius=_t(rad[sl]), dynamic=_t(dyn),
        row_dynamic=_t(dyn[sl]), **kw)
    for f in ("body_a", "body_b", "valid", "count"):
        _eq(getattr(got, f), getattr(want, f), f)


def test_find_pairs_partial_blocks_partition_find_pairs():
    mn, mx, rad, dyn = _partial_inputs()
    kw = dict(capacity=1024, block=64, margin=0.01)
    whole = brute_force.find_pairs(_t(mn), _t(mx), ball_radius=_t(rad),
                                   dynamic=_t(dyn), max_per_row=32, **kw)
    union, total = set(), 0
    for r0, r in ((0, 96), (96, 104)):
        sl = slice(r0, r0 + r)
        p = brute_force.find_pairs_partial(
            _t(mn[sl]), _t(mx[sl]), r0, _t(mn), _t(mx), ball_radius=_t(rad),
            row_ball_radius=_t(rad[sl]), dynamic=_t(dyn),
            row_dynamic=_t(dyn[sl]), **kw)
        union |= set(zip(p.body_a[p.valid].tolist(),
                         p.body_b[p.valid].tolist()))
        total += int(p.count)
    want = set(zip(whole.body_a[whole.valid].tolist(),
                   whole.body_b[whole.valid].tolist()))
    assert union == want and total == int(whole.count) == len(want) > 100


def _grid_inputs(seed=5, n=600):
    rng = np.random.default_rng(seed)
    mn, mx = _random(n, seed, spread=6.0, lo=0.2, hi=0.5)
    mn[:3] -= 4.0  # three outliers: the global list
    mx[:3] += 4.0
    rad = np.where(rng.random(n) < 0.5, np.nan, 0.45).astype(np.float32)
    return mn, mx, rad, rng


@pytest.mark.parametrize("case", ["active", "half_active", "rows",
                                  "rows_active_overhang"])
def test_grid_keywords_match_jax(case):
    mn, mx, rad, rng = _grid_inputs()
    n = len(mn)
    kw = dict(capacity=8192, max_per_body=32, cell_cap=16, global_cap=8,
              cand_budget=96)
    jkw, tkw = {}, {}
    if case in ("active", "rows_active_overhang"):
        act = rng.random(n) < 0.8
        jkw["active"], tkw["active"] = jnp.asarray(act), _t(act)
    if case == "half_active":
        # fewer than half active: entry n // 2 of the inf-padded sort is
        # +inf, so no body is global
        act = rng.random(n) < 0.3
        jkw["active"], tkw["active"] = jnp.asarray(act), _t(act)
    if case.startswith("rows"):
        r0, rc = (200, 150) if case == "rows" else (450, 200)
        jkw.update(row_offset=r0, row_count=rc)
        tkw.update(row_offset=torch.tensor(r0), row_count=rc)
    want = jgrid.find_pairs_grid(jnp.asarray(mn), jnp.asarray(mx),
                                 ball_radius=jnp.asarray(rad), margin=0.01,
                                 **kw, **jkw)
    got = grid.find_pairs_grid(_t(mn), _t(mx), ball_radius=_t(rad),
                               margin=0.01, **kw, **tkw)
    for f in ("body_a", "body_b", "valid", "count"):
        _eq(getattr(got, f), getattr(want, f), f)
    # no budget overflowed (a negative count); with under half active the
    # padded median is +inf and no body is global
    assert int(got.count) > 0


def test_grid_active_median_is_the_padded_sorts():
    """With ``active``, the global threshold is 3x entry N // 2 of the
    extents sorted with the inactive ones as +inf (the JAX package's rule),
    not 3x the active bodies' median: with 40 % active and 10 % of the
    active bodies four times wider, the padded median is +inf and the wide
    ones stay in the grid."""
    n = 100
    mn, mx = _random(n, 9, spread=8.0, lo=0.2, hi=0.2)
    act = np.arange(n) < 40
    mx[:4] += 1.2  # 4 of the 40 active bodies are wide
    want = set()
    for i in range(40):
        for j in range(i + 1, 40):
            if np.all((mn[i] <= mx[j]) & (mn[j] <= mx[i])):
                want.add((i, j))
    p = grid.find_pairs_grid(_t(mn), _t(mx), capacity=512, global_cap=2,
                             cell_cap=32, cand_budget=432, max_per_body=64,
                             active=_t(act))
    jp = jgrid.find_pairs_grid(jnp.asarray(mn), jnp.asarray(mx),
                               capacity=512, global_cap=2, cell_cap=32,
                               cand_budget=432, max_per_body=64,
                               active=jnp.asarray(act))
    _eq(p.count, jp.count)
    # no global overflow (4 wide bodies > global_cap 2 would flip the sign)
    assert int(p.count) == len(want)
    assert set(zip(p.body_a[p.valid].tolist(),
                   p.body_b[p.valid].tolist())) == want


@pytest.mark.parametrize("fn", ["prefix_sum", "prefix_sum_exclusive",
                                "prefix_sum_cpu", "radix_sort",
                                "argsort_u32"])
def test_scan_sort_matches_jax(fn):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 50, (3, 777)).astype(np.int32)
    keys = rng.integers(0, 40, 5000).astype(np.uint32)  # many ties
    vals = np.arange(5000, dtype=np.int32)
    if fn == "prefix_sum_cpu":
        np.testing.assert_array_equal(scan_sort.prefix_sum_cpu(x),
                                      jscan.prefix_sum_cpu(x))
    elif fn.startswith("prefix"):
        _eq(getattr(scan_sort, fn)(_t(x.astype(np.int64))),
            getattr(jscan, fn)(jnp.asarray(x)))
    elif fn == "radix_sort":
        wk, wv = jscan.radix_sort(jnp.asarray(keys), jnp.asarray(vals))
        gk, gv = scan_sort.radix_sort(_t(keys.astype(np.int64)),
                                      _t(vals.astype(np.int64)))
        _eq(gk, wk)
        _eq(gv, wv)
    else:
        _eq(scan_sort.argsort_u32(_t(keys.astype(np.int64))),
            jscan.argsort_u32(jnp.asarray(keys)))


def test_scan_sort_module_matches_the_jax_registry():
    """``utils.scan_sort`` is registered as in the JAX package: the same
    entry points and provided functions, and each entry point runs."""
    from wgmath_tpu.core import module as jax_module
    from wgmath_tpu_torch.core.module import compile_check, get_module

    ours = get_module("utils.scan_sort")
    theirs = jax_module.get_module("utils.scan_sort")
    assert list(ours.entries) == list(theirs.entries)
    assert list(ours.provides) == list(theirs.provides)
    assert compile_check("utils.scan_sort", device="cpu") == list(
        ours.entries)
