"""The port's sharded steps on gloo ranks on the CPU, against the JAX
package's sharded steps on its virtual 8-device mesh and against the
port's own single-device step.

The JAX runs (``tests/test_parallel.py``'s cases) are stored in
``artifacts/parallel_jax.npz.xz`` (``scripts/export_parallel_npz.py``):
``balls(192)`` after 25 warm frames under the full pipeline's
configuration (6 sharded frames) and under the window ladder (5 frames),
``pendulum_chain(6, "spherical")`` after 5 (5 frames), and one frame of
the round-1 body-sharded step on ``balls(63)``. The port runs each case on
2 and on 4 spawned gloo ranks (``tests/parallel_ranks.py``, all cases of
one rank count in one spawn, one PyTorch thread a rank) and holds it

- within 1e-5 m of JAX's sharded frames (JAX's own tolerance to its
  single-device step);
- within 1e-6 m of the port's single-device step on the same state;
- with the pair and contact counts exact and the broad-phase cache pairs
  exact, against both;
- with the ranks' states equal bit for bit after every frame.

Besides: the narrow phase's compactions (ball-cuboid, cuboid-cuboid and
support-mapped pairs) on ``primitives3`` from the JAX package's warmed
state (``artifacts/primitives3_small.npz``), with ``pair_capacity`` well
above the pair count and each compaction capacity sized for one device,
equal to the single-device step bit for bit with no rank over its share;
the full pipeline with a broad-phase refresh forced every frame,
on the grid and on the brute force (the row-block broad phase), equal to
the single-device step bit for bit; one rank's broad-phase overflow makes
every rank's count negative; a ``pair_capacity`` that is not a multiple of
the rank count, and a rank count that is not the group's, raise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.parallel_ranks import run_ranks
from wgmath_tpu_torch.broad_phase.brute_force import find_pairs_partial
from wgmath_tpu_torch.convert import (
    load_arrays,
    state_from_arrays,
    state_to_arrays,
)
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step
from wgmath_tpu_torch.scenes.builders import balls
from wgmath_tpu_torch.shapes.shape import ball_radii_or_nan, world_aabbs
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "parallel_jax.npz.xz")
NPZ_PRIM = os.path.join(ROOT, "artifacts", "primitives3_small.npz")
PRIM = "primitives3.ladder"
CASES = {"full": 6, "ladder": 5, "joints": 5}
WORLDS = (2, 4)
# one rank's rows overflow: the last ten balls of balls(63) in one clump
CLUMP = 10


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _state(z, case):
    pre = f"{case}.state."
    return state_from_arrays({k[len(pre):]: v for k, v in z.items()
                              if k.startswith(pre)}, "cpu")


def _config(z, case) -> PipelineConfig:
    return PipelineConfig.from_dict(json.loads(str(z[f"{case}.config_json"])))


def _clump_state():
    st = balls(63, device="cpu")
    tr = st.bodies.poses.translation.clone()
    tr[-CLUMP:] = torch.tensor([0.0, 10.0, 0.0]) + 0.1 * torch.arange(
        CLUMP, dtype=torch.float32)[:, None]
    return dataclasses.replace(st, bodies=dataclasses.replace(
        st.bodies, poses=dataclasses.replace(st.bodies.poses,
                                             translation=tr)))


CLUMP_CFG = PipelineConfig(pair_capacity=2048, max_colors=8,
                           bp_algo="brute", broad_phase_max_per_row=4,
                           manifold_points=1)


def _prim_state():
    z = np.load(NPZ_PRIM)
    pre = f"{PRIM}.state."
    return state_from_arrays({k[len(pre):]: z[k] for k in z.files
                              if k.startswith(pre)}, "cpu")


def _prim_config() -> PipelineConfig:
    """The stored ``primitives3`` configuration with ``pair_capacity`` at
    four times the stored one (the pairs fill under a tenth of it) and
    each compaction capacity 1.5 times the single device's demand on the
    stored state, rounded up to 8: what one device needs, where each
    rank's share is a quarter or a half of it."""
    cfg = PipelineConfig.from_dict(json.loads(str(np.load(NPZ_PRIM)[
        f"{PRIM}.config_json"])))
    need = step(_prim_state(), SimParams(), cfg).pair_count[5:8].tolist()
    caps = [-(-int(1.5 * d) // 8) * 8 for d in need]
    return dataclasses.replace(
        cfg, pair_capacity=4 * cfg.pair_capacity, bc_pair_capacity=caps[0],
        sat_pair_capacity=caps[1], pfm_pair_capacity=caps[2])


def _jobs(z):
    params = SimParams()
    jobs = [("pipeline", dict(arrays=state_to_arrays(_state(z, c)),
                              params=params, config=_config(z, c),
                              frames=n)) for c, n in CASES.items()]
    for algo in ("grid", "brute"):
        jobs.append(("pipeline", dict(
            arrays=state_to_arrays(_state(z, "full")), params=params,
            config=dataclasses.replace(_config(z, "full"), bp_algo=algo,
                                       bp_force="miss"), frames=3)))
    jobs.append(("round1", dict(arrays=state_to_arrays(_state(z, "round1")),
                                params=params, config=_config(z, "round1"))))
    jobs.append(("pipeline", dict(arrays=state_to_arrays(_clump_state()),
                                  params=params, config=CLUMP_CFG,
                                  frames=1)))
    jobs.append(("refuse", dict(arrays=state_to_arrays(_state(z, "full")),
                                params=params, config=_config(z, "full"))))
    jobs.append(("pipeline", dict(arrays=state_to_arrays(_prim_state()),
                                  params=params, config=_prim_config(),
                                  frames=PRIM_FRAMES)))
    return jobs


JOB = {"full": 0, "ladder": 1, "joints": 2, "miss_grid": 3,
       "miss_brute": 4, "round1": 5, "clump": 6, "refuse": 7,
       "compactions": 8}
PRIM_FRAMES = 2


@pytest.fixture(scope="module")
def ranks(z):
    """``ranks[world][rank][job]``, each rank count spawned once."""
    jobs = _jobs(z)
    return {w: run_ranks(jobs, w) for w in WORLDS}


def _single(state, params, cfg, frames: int):
    out = []
    for _ in range(frames):
        state = step(state, params, cfg, warmstart=True)
        out.append(state)
    return out


def _check_equal_ranks(res: list, job: int):
    digests = [r[job]["digest"] for r in res]
    for d in digests[1:]:
        assert d == digests[0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_pipeline_matches_jax_and_single_device(z, ranks, case,
                                                        world):
    res = ranks[world]
    got = res[0][JOB[case]]
    _check_equal_ranks(res, JOB[case])
    single = _single(_state(z, case), SimParams(), _config(z, case),
                     CASES[case])
    for f in range(CASES[case]):
        tr = got["translation"][f]
        want = z[f"{case}.frame{f}.translation"]
        np.testing.assert_allclose(tr, want, rtol=0, atol=1e-5,
                                   err_msg=f"{case} frame {f} vs JAX")
        sd = single[f]
        np.testing.assert_allclose(
            tr, sd.bodies.poses.translation.numpy(), rtol=0, atol=1e-6,
            err_msg=f"{case} frame {f} vs the single-device step")
        counts = got["pair_count"][f]
        np.testing.assert_array_equal(counts[:2],
                                      z[f"{case}.frame{f}.pair_count"][:2])
        np.testing.assert_array_equal(counts[:2], sd.pair_count[:2].numpy())
    if f"{case}.bp_pairs" in z:
        bp = got["bp_pairs"][-1]
        np.testing.assert_array_equal(bp, z[f"{case}.bp_pairs"])
        sd = single[-1].bp_pairs
        np.testing.assert_array_equal(bp, np.stack([
            sd.body_a.numpy(), sd.body_b.numpy(),
            sd.valid.numpy().astype(np.int64)]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("algo", ["grid", "brute"])
def test_sharded_broad_phase_refresh_is_the_single_device_step(z, ranks,
                                                                algo,
                                                                world):
    """A refresh every frame: the row-block broad phase, gathered and
    compacted in rank order, gives the single-device pair list, so the
    whole frame equals the single-device step bit for bit."""
    job = JOB[f"miss_{algo}"]
    res = ranks[world]
    _check_equal_ranks(res, job)
    cfg = dataclasses.replace(_config(z, "full"), bp_algo=algo,
                              bp_force="miss")
    single = _single(_state(z, "full"), SimParams(), cfg, 3)
    for f, sd in enumerate(single):
        assert int(sd.pair_count[3]) == 2  # a full refresh
        got = res[0][job]
        np.testing.assert_array_equal(got["translation"][f],
                                      sd.bodies.poses.translation.numpy())
        np.testing.assert_array_equal(got["pair_count"][f],
                                      sd.pair_count.numpy())
        np.testing.assert_array_equal(got["bp_pairs"][f], np.stack([
            sd.bp_pairs.body_a.numpy(), sd.bp_pairs.body_b.numpy(),
            sd.bp_pairs.valid.numpy().astype(np.int64)]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_compactions_are_the_single_device_step(ranks, world):
    """The narrow phase's ball-cuboid, cuboid-cuboid and support-mapped
    compactions at capacities sized for one device: every rank takes its
    share of the pairs packed at the front of the list, none goes over its
    share of a capacity, and the frames equal the single-device step's bit
    for bit (a dropped pair would change the contacts)."""
    job = JOB["compactions"]
    res = ranks[world]
    _check_equal_ranks(res, job)
    cfg = _prim_config()
    caps = [cfg.bc_pair_capacity, cfg.sat_pair_capacity,
            cfg.pfm_pair_capacity]
    single = _single(_prim_state(), SimParams(), cfg, PRIM_FRAMES)
    for f, sd in enumerate(single):
        want = sd.pair_count.numpy()
        assert 0 < want[0] <= cfg.pair_capacity // 8
        # the single device's demands would overflow one rank holding all
        assert all(d > c // world for d, c in zip(want[5:8], caps))
        got = res[0][job]
        np.testing.assert_array_equal(got["translation"][f],
                                      sd.bodies.poses.translation.numpy())
        pc = got["pair_count"][f]
        np.testing.assert_array_equal(pc[:5], want[:5])
        np.testing.assert_array_equal(pc[8:], want[8:])
        assert all(d <= c for d, c in zip(pc[5:8], caps)), (pc[5:8], caps)


@pytest.mark.parametrize("world", WORLDS)
def test_round1_body_sharded_step(z, ranks, world):
    """The body-sharded step (``parallel.sharded``): each rank's rows,
    put together, against JAX's 8-device frame and the single-device step;
    its pair count is the brute force's on the same state."""
    res = ranks[world]
    st = _state(z, "round1")
    cfg = _config(z, "round1")
    n = st.bodies.num_bodies
    tr = np.concatenate([r[JOB["round1"]]["translation"] for r in res])[:n]
    lin = np.concatenate([r[JOB["round1"]]["linear"] for r in res])[:n]
    assert np.isfinite(tr).all()
    np.testing.assert_allclose(tr, z["round1.frame0.translation"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lin, z["round1.frame0.linear"], rtol=0,
                               atol=1e-5)
    params = SimParams()
    sd = step(st, params, cfg, warmstart=False)
    np.testing.assert_allclose(tr, sd.bodies.poses.translation.numpy(),
                               rtol=0, atol=1e-6)
    mins, maxs = world_aabbs(st.shapes, st.bodies.poses,
                             margin=params.prediction_distance)
    radii = ball_radii_or_nan(st.shapes, st.bodies.poses)
    brute = find_pairs_partial(mins, maxs, 0, mins, maxs,
                               capacity=cfg.pair_capacity,
                               block=cfg.broad_phase_block,
                               max_per_row=cfg.broad_phase_max_per_row,
                               ball_radius=radii,
                               margin=params.prediction_distance)
    counts = {r[JOB["round1"]]["pair_count"] for r in res}
    assert counts == {int(brute.count)} == {int(
        z["round1.frame0.pair_count"])}


@pytest.mark.parametrize("world", WORLDS)
def test_one_ranks_overflow_makes_every_count_negative(ranks, world):
    st = _clump_state()
    params = SimParams()
    mins, maxs = world_aabbs(st.shapes, st.bodies.poses,
                             margin=params.prediction_distance)
    n = mins.shape[0]
    nb = -(-n // world)
    radii = ball_radii_or_nan(st.shapes, st.bodies.poses)
    dyn = st.bodies.is_dynamic()
    over = []
    for k in range(world):
        rows = slice(k * nb, min((k + 1) * nb, n))
        p = find_pairs_partial(
            mins[rows], maxs[rows], k * nb, mins, maxs,
            capacity=CLUMP_CFG.pair_capacity // world,
            max_per_row=CLUMP_CFG.broad_phase_max_per_row,
            ball_radius=radii, row_ball_radius=radii[rows],
            margin=params.prediction_distance, dynamic=dyn,
            row_dynamic=dyn[rows])
        over.append(int(p.count) < 0)
    assert over == [False] * (world - 1) + [True]
    counts = [int(r[JOB["clump"]]["pair_count"][0][0])
              for r in ranks[world]]
    single = step(st, params, CLUMP_CFG, warmstart=False)
    assert int(single.pair_count[0]) < 0
    assert all(c == int(single.pair_count[0]) for c in counts)


@pytest.mark.parametrize("world", WORLDS)
def test_bad_shards_raise(ranks, world):
    for r in ranks[world]:
        err = r[JOB["refuse"]]
        assert "multiple of the rank count" in err["make_sharded_step"]
        assert "multiple of the rank count" in err["step"]
        assert f"not {world + 1}" in err["ranks"]
