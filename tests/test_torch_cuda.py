"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the port's own step on the card against the same step on the CPU.

These tests need a CUDA device and skip without one. They import no JAX,
so the machine with the card runs them without the repository's conftest::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from chip_smoke import NPZ, gs_math_inputs
from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.dynamics import gs_math
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked

# the JAX package's tolerance for this math (tests/test_physics.py)
RTOL, ATOL = 1e-4, 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 1000, 5504])
@pytest.mark.parametrize("p_max", [1, 4])
@pytest.mark.parametrize("mode", ["biased", "unbiased"])
def test_gs_math_kernel_matches_plain_on_card(mode, p_max, L):
    _need_card()
    args, kw = gs_math_inputs(np.random.default_rng(L + p_max), L, p_max,
                              mode, "cuda")
    launches = gs_math.LAUNCHES
    got = gs_math.gs_math_block_rhs(*args, **kw)
    want = gs_math._gs_math_rhs_torch(*args, **kw)
    torch.cuda.synchronize()
    assert gs_math.LAUNCHES == launches + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_pit10k_frames_on_card_match_cpu():
    """Two frames of the settled 10k pit (a full refresh with a Luby
    recolour, then a cache hit) on the card and on the CPU: sorts, scans,
    scatter-mins and the colouring give the same integers; poses agree to
    float32 reordering."""
    _need_card()
    z = dict(np.load(NPZ))
    cfg0 = PipelineConfig.from_dict(json.loads(str(z["config_json"])))
    out = {}
    for dev in ("cpu", "cuda"):
        state, cfg = state_from_arrays(z, device=dev), cfg0
        for _ in range(2):
            state, cfg = step_checked(state, SimParams(), cfg)
        out[dev] = (state, cfg)
    (sc, cc), (sg, cg) = out["cpu"], out["cuda"]
    assert cc == cg
    np.testing.assert_array_equal(sg.pair_count.cpu().numpy(),
                                  sc.pair_count.numpy())
    np.testing.assert_array_equal(sg.bp_colors[0].cpu().numpy(),
                                  sc.bp_colors[0].numpy())
    for f in ("body_a", "body_b", "valid"):
        np.testing.assert_array_equal(
            getattr(sg.bp_pairs, f).cpu().numpy(),
            getattr(sc.bp_pairs, f).numpy())
    np.testing.assert_allclose(
        sg.bodies.poses.translation.cpu().numpy(),
        sc.bodies.poses.translation.numpy(), rtol=1e-5, atol=1e-5)
