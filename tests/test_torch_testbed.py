"""The port's testbed and run tools against the JAX package's, on the CPU.

- ``core.profiling``: ``RunStats`` (keys and ``summary()`` as JAX's),
  ``PhaseTimer`` and ``timeit``;
- ``utils.checkpoint``: a round trip gives the state back bit for bit
  (every tensor's dtype, shape and bytes), with the broad-phase cache, the
  colours, the solve cache and the joints;
- ``scenes.builders``: ``SCENES`` holds JAX's 25 keys in JAX's order, and
  ``conveyor`` and ``boxes_and_balls(400, dim=3)`` build JAX's states bit
  for bit;
- ``conveyor3``: three ``step_checked`` frames under the testbed's
  configuration within 1e-5 m of JAX's (``artifacts/parallel_jax.npz.xz``,
  ``scripts/export_parallel_npz.py``), the counts exact, the platform at
  x = v·t;
- ``testbed.oracle``: the port's oracle gives JAX's oracle's positions and
  rotations bit for bit on the same scene;
- ``testbed.runner``: ``main(["--list"])`` prints what JAX's prints,
  ``run_scene("balls3", frames=3, device="cpu", verify=True)`` runs, the
  oracle backend runs ``conveyor3``, and without CUDA a run that does not
  ask for the CPU raises;
- ``testbed.live``: the headless ``LiveViewer`` state machine of
  ``tests/test_testbed_live.py`` (skipped without matplotlib).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.parallel_ranks import state_digest
from wgmath_tpu_torch.convert import (
    load_arrays,
    state_from_arrays,
    state_to_arrays,
)
from wgmath_tpu_torch.core.profiling import PhaseTimer, RunStats, timeit
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import (
    PipelineConfig,
    auto_manifold_points,
    step,
    step_checked,
)
from wgmath_tpu_torch.scenes import builders
from wgmath_tpu_torch.testbed import runner
from wgmath_tpu_torch.utils import checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "parallel_jax.npz.xz")


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _stored(z, case):
    pre = f"{case}.state."
    return state_from_arrays({k[len(pre):]: v for k, v in z.items()
                              if k.startswith(pre)}, "cpu")


def _config(z, key) -> PipelineConfig:
    return PipelineConfig.from_dict(json.loads(str(z[key])))


def test_run_stats_and_phase_timer():
    from wgmath_tpu.core.profiling import RunStats as JaxRunStats

    stats, want = RunStats(), JaxRunStats()
    for s in (stats, want):
        s.add_phase("step", 2.0)
        s.add_phase("step", 1.5)
        s.add_phase("broad_phase", 4.0)
        s.bump("steps")
        s.bump("steps", 2)
        s.bump("capacity_regrowths")
    assert dataclasses.asdict(stats) == dataclasses.asdict(want)
    assert stats.summary() == want.summary()
    assert stats.total_ms() == 7.5
    timer = PhaseTimer(stats)
    with timer.phase("solve") as h:
        h.append(torch.ones(3) * 2)
    with timer.phase("narrow_phase", result=(torch.zeros(2), [None])):
        pass
    assert stats.phase_ms["solve"] >= 0.0
    assert set(stats.phase_ms) == {"step", "broad_phase", "solve",
                                   "narrow_phase"}
    calls = []
    t = timeit(lambda x: calls.append(1) or x + 1, torch.ones(4), iters=5,
               warmup=2)
    assert t >= 0.0 and len(calls) == 7


def _tensors(obj, prefix, out):
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            _tensors(x, f"{prefix}.{i}", out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), f"{prefix}.{f.name}", out)
    else:
        out[prefix] = obj
    return out


@pytest.mark.parametrize("case", ["full", "joints"])
def test_checkpoint_round_trip_is_bit_for_bit(z, tmp_path, case):
    st = step(_stored(z, case), SimParams(), _config(z, f"{case}.config_json"),
              warmstart=True)
    if case == "full":
        assert st.bp_pairs is not None and st.bp_colors is not None
        assert st.solve_cache is not None and st.prev_colors is not None
    else:
        assert st.joints is not None
    path = str(tmp_path / "state.pt")
    checkpoint.save(path, st)
    back = checkpoint.load(path, device="cpu")
    a, b = _tensors(st, "s", {}), _tensors(back, "s", {})
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        w = b[k]
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert torch.equal(v, w) and (v.numpy().tobytes()
                                          == w.numpy().tobytes()), k
        else:
            assert v == w, k
    # the state steps on as it would have
    cfg = _config(z, f"{case}.config_json")
    n1 = step(st, SimParams(), cfg)
    n2 = step(back, SimParams(), cfg)
    assert torch.equal(n1.bodies.poses.translation,
                       n2.bodies.poses.translation)


def test_scenes_are_jax_s_in_jax_s_order():
    from wgmath_tpu.scenes.builders import SCENES as JAX_SCENES

    assert list(builders.SCENES) == list(JAX_SCENES)
    assert len(builders.SCENES) == 25


@pytest.mark.parametrize("name", ["conveyor", "boxes_and_balls3"])
def test_builders_equal_jax(name):
    from wgmath_tpu.scenes import builders as jax_builders

    if name == "conveyor":
        got, want = builders.conveyor(device="cpu"), jax_builders.conveyor()
    else:
        got = builders.SCENES[name](device="cpu")
        want = jax_builders.SCENES[name]()
    assert state_digest(state_to_arrays(got)) == state_digest(
        state_to_arrays(want))


def test_conveyor3_frames_match_jax(z):
    st = builders.SCENES["conveyor3"](device="cpu")
    assert state_digest(state_to_arrays(st)) == state_digest(
        state_to_arrays(_stored(z, "conveyor3")))
    params = SimParams.tgs_soft()
    cfg = runner.BackendConfig().pipeline_config(
        manifold_points=auto_manifold_points(st.shapes, 3))
    assert cfg == _config(z, "conveyor3.config_json")
    speed = float(st.bodies.vels.linear[1, 0])
    for f in range(3):
        st, cfg = step_checked(st, params, cfg)
        tr = st.bodies.poses.translation.numpy()
        np.testing.assert_allclose(tr, z[f"conveyor3.frame{f}.translation"],
                                   rtol=0, atol=1e-5, err_msg=f"frame {f}")
        np.testing.assert_array_equal(
            st.pair_count[:2].numpy(), z[f"conveyor3.frame{f}.pair_count"][:2])
        np.testing.assert_allclose(tr[1, 0], speed * params.dt * (f + 1),
                                   rtol=1e-6, atol=0)
    assert cfg == _config(z, "conveyor3.final_config_json")


def test_oracle_equals_jax_oracle_bit_for_bit():
    from wgmath_tpu.scenes import builders as jax_builders
    from wgmath_tpu.testbed import oracle as jax_oracle
    from wgmath_tpu_torch.testbed import oracle

    for scene in ("conveyor3", "boxes_and_balls3"):
        frames = 5 if scene == "conveyor3" else 1
        got = oracle.run_oracle_backend(
            builders.SCENES[scene](device="cpu"), frames)
        want = jax_oracle.run_oracle_backend(jax_builders.SCENES[scene](),
                                             frames)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float64
            assert g.tobytes() == w.tobytes(), scene


def test_list_prints_what_jax_prints(capsys):
    from wgmath_tpu.testbed import runner as jax_runner

    assert jax_runner.main(["--list"]) == 0
    want = capsys.readouterr().out
    assert runner.main(["--list"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.split()) == 25


def test_run_scene_balls3_on_the_cpu():
    final = {}
    stats = runner.run_scene("balls3", frames=3, device="cpu", verify=True,
                             final=final)
    assert stats.counters["steps"] == 3
    assert set(stats.phase_ms) == {"first_step", "step"}
    assert final["positions"].shape == (1001, 3)
    assert np.isfinite(final["positions"]).all()


def test_runner_cli_json_and_oracle_backend(capsys):
    assert runner.main(["--device", "cpu", "--example", "conveyor3",
                        "--frames", "2", "--verify", "--json"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scene"] == "conveyor3" and line["finite"]
    assert line["counters"]["steps"] == 2 and line["bodies"] == 50
    stats = runner.run_scene("conveyor3", frames=5, backend="oracle",
                             device="cpu", verify=True)
    assert stats.counters["steps"] == 5
    assert runner.main(["--example", "no_such_scene"]) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_runner_raises_without_cuda_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main(["--example", "balls3", "--frames", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run_scene("balls3", frames=1)


def _finite(v):
    return bool(torch.isfinite(v.state.bodies.poses.translation).all())


def test_live_viewer_switches_backends():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    from wgmath_tpu_torch.testbed.live import LiveViewer

    v = LiveViewer("balls2", pair_capacity=4096, device="cpu")
    for _ in range(3):
        v.advance()
    assert v.frame == 3 and _finite(v)
    assert v.backend.solver == "tgs"
    v.on_key("t")  # the runtime solver switch: same state, new config
    assert v.backend.solver == "jacobi" and v.config.use_jacobi
    assert v.state.solve_cache is None and v.state.bp_pairs is None
    v.advance()
    assert v.frame == 4 and _finite(v)
    v.on_key("c")  # the chained sweep (back to TGS)
    assert v.backend.gs_chained and v.backend.solver == "tgs"
    v.advance()
    assert _finite(v)
    v.on_key(" ")
    assert v.paused
    f = v.frame
    v.on_key("n")
    assert v.frame == f + 1
    v.on_key(" ")
    assert not v.paused
    v.on_key("r")
    assert v.frame == 0 and _finite(v)
    v.advance()
    s = v.status()
    assert "tgs+chained" in s and "frame 1" in s and "pairs" in s
    v.on_key("q")
    assert v.closed


def test_live_viewer_draws_headless_meshes_and_picker():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from wgmath_tpu_torch.testbed.live import LiveViewer

    v = LiveViewer("balls2", pair_capacity=4096, frames=2, device="cpu")
    v.advance()
    fig = plt.figure()
    ax = fig.add_subplot(111)
    v.draw(fig, ax)
    assert "balls2" in ax.get_title(loc="left")
    plt.close(fig)

    v = LiveViewer("keva3", pair_capacity=8192, frames=2, device="cpu")
    assert v.dim == 3 and not v.mesh_mode
    v.on_key("m")
    assert v.mesh_mode
    v.advance()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    v.draw(fig, ax)
    assert len(ax.collections) >= 1
    plt.close(fig)
    pos = v.state.bodies.poses.translation.numpy()
    rot = v.state.bodies.poses.rotation.numpy()
    tris, _ = v._inst.world_polys(rot, pos, v.dynamic)
    assert len(tris) == 12 * len(pos) and np.isfinite(tris).all()
    names = sorted(builders.SCENES)
    i = names.index("keva3")
    v.on_key("]")
    assert v.scene == names[(i + 1) % len(names)] and v.frame == 0
    v.on_key("[")
    assert v.scene == "keva3"


def test_recorder_and_renderer(tmp_path):
    pytest.importorskip("matplotlib")
    from wgmath_tpu_torch.testbed.viewer import Recorder, render_npz

    path = str(tmp_path / "rec.npz")
    assert runner.main(["--device", "cpu", "--example", "balls2",
                        "--frames", "3", "--record", path]) == 0
    with np.load(path) as rec:
        assert rec["positions"].shape == (3, 301, 2)
        assert rec["dynamic"].sum() == 300
    pngs = render_npz(path, str(tmp_path / "frames"), every=2)
    assert len(pngs) == 2 and all(os.path.exists(p) for p in pngs)
    assert isinstance(Recorder, type)
