"""How B7 (``csrc/reduce.cu``) cuts a call over its grid and folds it, on
the CPU and without JAX.

The kernel reads x in groups of 4 elements, gives each block of a
persistent grid one contiguous share of the groups, and lets the block
that draws the last ticket fold the blocks' partials by index.
``reduce_plan`` and ``fold_order`` write that partition and order out, and
``_reduce_emulated`` runs it in f32 on the CPU. Here the plan is held to
cover every element exactly once, on either load route; the emulation is
held against the plain version within the smoke test's ``REDUCE_TOL``; and
blocks that finish in a random order are shown to give the same bits,
where a fold in the order of arrival would not. The kernel itself runs on
the card (``tests/test_torch_cuda.py``, which also holds it to the
emulation bit for bit).
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import REDUCE_TOL
from tests.torch_threads import one_torch_thread  # noqa: F401

reduce_ops = importlib.import_module("wgmath_tpu_torch.ops.reduce")

OPS = tuple(reduce_ops._OPS)
# lengths around the group, share and round edges; 4096 * k +- 1
LENGTHS = (1, 3, 4, 5, 1027, 4095, 4097, 12287, 12289, 262143, 262145,
           1_000_003)
H100_BLOCKS = 264  # 132 SMs x 2 blocks


def _x(n: int, seed: int = 0) -> torch.Tensor:
    """The smoke test's draw: factors near 1 with random signs, so that the
    product of a million stays in range and the sum nearly cancels."""
    rng = np.random.default_rng(seed + n)
    return torch.from_numpy((rng.uniform(0.999, 1.001, size=n)
                             * rng.choice([-1.0, 1.0], size=n))
                            .astype(np.float32))


def _grids(n: int) -> list[int]:
    return sorted({1, 3, reduce_ops.grid(n, H100_BLOCKS), H100_BLOCKS})


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_plan_folds_every_element_exactly_once(n, aligned):
    for blocks in _grids(n):
        plan = reduce_ops.reduce_plan(n, blocks, aligned)
        assert len(plan) == blocks
        # contiguous, even shares of the groups, in block order
        sizes = [p.groups[1] - p.groups[0] for p in plan]
        assert plan[0].groups[0] == 0 and plan[-1].groups[1] == -(-n // 4)
        assert all(a.groups[1] == b.groups[0] for a, b in zip(plan, plan[1:]))
        assert max(sizes) - min(sizes) <= 1
        # each block's float4 groups and scalar elements cover its elements
        seen = torch.zeros(n, dtype=torch.int64)
        for p in plan:
            (v0, v1), (s0, s1) = p.float4, p.scalars
            assert 4 * v0 == p.elements[0] and 4 * v1 == s0
            assert s1 == p.elements[1]
            seen[4 * v0:4 * v1] += 1
            seen[s0:s1] += 1
            if aligned:  # only the short last group takes scalar loads
                assert s1 - s0 == (n % 4 if s1 == n and s1 > s0 else 0)
            else:
                assert v0 == v1
        assert bool((seen == 1).all())
        # the fold order: every element once, inside its block's share
        index, active = reduce_ops.fold_order(n, blocks)
        valid = index[index >= 0]
        assert torch.equal(valid.sort().values, torch.arange(n))
        for b, p in enumerate(plan):
            mine = index[b][index[b] >= 0]
            assert bool(((mine >= p.elements[0])
                         & (mine < p.elements[1])).all())
        # a round a thread does not run holds no element
        assert bool((index[~active] == -1).all())


@pytest.mark.parametrize("n", [1, 4097, 8192, 8193, 1_000_003, 4_194_304])
def test_grid_gives_each_block_a_few_thousand_elements(n):
    blocks = reduce_ops.grid(n, H100_BLOCKS)
    assert 1 <= blocks <= H100_BLOCKS
    # one block (no ticket) up to MIN_SHARE elements
    assert (blocks == 1) == (n <= reduce_ops.MIN_SHARE)
    if blocks > 1:
        shares = [p.elements[1] - p.elements[0]
                  for p in reduce_ops.reduce_plan(n, blocks, True)]
        assert min(shares) >= reduce_ops.MIN_SHARE // 2 - 4


@pytest.mark.parametrize("n", [1, 5, 1027, 4097, 1_000_003])
@pytest.mark.parametrize("op", OPS)
def test_emulation_matches_the_plain_version(op, n):
    x = _x(n)
    want = reduce_ops._reduce_torch(x, op)
    pre = reduce_ops._OPS[op][0]
    scale = (abs(float(want)) if op in ("prod", "min", "max")
             else float(pre(x).abs().sum()))
    for blocks in _grids(n):
        got = reduce_ops._reduce_emulated(x, op, blocks)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= REDUCE_TOL[op] * scale, \
            (blocks, float(got), float(want))


@pytest.mark.parametrize("op", OPS)
def test_blocks_finishing_in_any_order_give_the_same_bits(op):
    """The ticket emulated: blocks store their partials and draw tickets in
    a random order; the one that draws the last folds the partials by
    index. The result is the same bits for every order and equal to
    ``_reduce_emulated``. A fold in the order of arrival, as a float atomic
    would make, changes with the order for sum, sqnorm and prod."""
    n = 100_003
    x = _x(n, 7)
    blocks = reduce_ops.grid(n, H100_BLOCKS)
    assert blocks > 1
    partials = reduce_ops._block_partials(x, op, blocks)
    rng = np.random.default_rng(11)
    results, by_arrival = set(), set()
    for _ in range(20):
        stored = torch.full((blocks,), float("nan"))
        written = torch.zeros(blocks, dtype=torch.bool)
        ticket = 0
        arrival = torch.tensor(reduce_ops._OPS[op][2], dtype=torch.float32)
        for b in rng.permutation(blocks):
            stored[b], written[b] = partials[b], True
            arrival = reduce_ops._combine(op, arrival, partials[b])
            if ticket == blocks - 1:
                assert bool(written.all())
                out = reduce_ops._final_fold(stored, op)
            ticket += 1
        results.add(out.numpy().tobytes())
        by_arrival.add(arrival.numpy().tobytes())
    assert results == {reduce_ops._reduce_emulated(x, op, blocks)
                       .numpy().tobytes()}
    if op in ("sum", "sqnorm", "prod"):
        assert len(by_arrival) > 1
