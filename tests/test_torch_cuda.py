"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the port's own step on the card against the same step on the CPU.

These tests need a CUDA device and skip without one. They import no JAX,
so the machine with the card runs them without the repository's conftest::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (
    NPZ,
    NPZ_LADDER,
    gs_block_inputs,
    gs_block_plain,
    gs_math_inputs,
)
from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.dynamics import gs_math
from wgmath_tpu_torch.dynamics.constraint import update_rhs_sorted
from wgmath_tpu_torch.geometry.sim import Sim
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
@pytest.mark.parametrize("L", [128, 1000, 4096])
@pytest.mark.parametrize("p_max", [1, 4])
def test_gs_math_block_kernel_matches_plain_on_card(p_max, L):
    _need_card()
    args, kw = gs_block_inputs(np.random.default_rng(L + p_max), L, p_max,
                               "cuda")
    launches = gs_math.LAUNCHES_BLOCK
    got = gs_math.gs_math_block(*args, **kw)
    want = gs_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert gs_math.LAUNCHES_BLOCK == launches + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    # an inactive row returns its previous impulses bit for bit
    off = ~args[3]
    assert torch.equal(got[0][off], args[6][off])
    assert torch.equal(got[1][off], args[7][off])


@pytest.mark.cuda
@pytest.mark.parametrize("p_max", [1, 4])
def test_rhs_in_rung_equals_rhs_passed_in_bit_for_bit(p_max):
    """The rhs rebuilt inside ``gs_math.cu`` and the rhs that
    ``update_rhs_sorted`` hands to ``gs_math_block.cu`` are the same bits
    (so ``chained_rr`` and ``ladder`` are one trajectory on the card):
    ``update_rhs_sorted`` sums its dot products in the kernel's order, which
    a ``torch.sum`` reduction on the card does not."""
    _need_card()
    L = 4096
    args, kw = gs_math_inputs(np.random.default_rng(p_max), L, p_max,
                              "biased", "cuda")
    win, meta, num_points, active, p1, p2, prev_n, prev_t = args
    out_rr = gs_math.gs_math_block_rhs(*args, **kw)
    pose = torch.cat([kw["pose1"], kw["pose2"]])
    idx = torch.arange(L, device="cuda")
    ss = SimpleNamespace(body_a=idx, body_b=idx + L,
                         **gs_math._fields(win, meta))
    inv_dt, erp_inv_dt, allowed, max_corr, cfm = kw["consts"]
    n_rhs, n_rhs_wo, t_rhs = update_rhs_sorted(
        ss, Sim(pose[:, :4], pose[:, 4:7], pose[:, 7]),
        SimpleNamespace(inv_dt=inv_dt, contact_erp_inv_dt=erp_inv_dt,
                        allowed_linear_error=allowed,
                        max_corrective_velocity=max_corr))
    view = SimpleNamespace(
        cfm_factor=torch.full((L,), cfm, device="cuda"), n_rhs=n_rhs,
        t_rhs=t_rhs, num_points=num_points)
    out = gs_math.gs_math_block(win, meta, view, active, p1[:, :6],
                                p2[:, :6], prev_n, prev_t, p_max=p_max,
                                s_len=2)
    torch.cuda.synchronize()
    assert torch.equal(n_rhs_wo, out_rr[4])
    for got, want in zip(out, out_rr[:4]):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [NPZ, NPZ_LADDER],
                         ids=["chained_ps", "ladder"])
def test_pit10k_frames_on_card_match_cpu(path):
    """Two frames of the settled 10k pit (a full refresh with a Luby
    recolour, then a cache hit) on the card and on the CPU, under the
    stored ``chained_ps`` and ``ladder`` configurations: sorts, scans,
    scatter-mins and the colouring give the same integers; poses agree to
    float32 reordering."""
    _need_card()
    z = dict(np.load(NPZ))
    cfg0 = PipelineConfig.from_dict(
        json.loads(str(np.load(path)["config_json"])))
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
