"""Step tall cuboid pyramids on the card from their first state and print,
every sixth frame and at the last, the counts, the boxes' drops (median,
largest), level 0's distance from y = 0.5, each sampled level's drop past
the 0.01 m gaps below it, the deepest penetration and the kinetic-energy
proxy: how a pyramid settles or falls in on itself under the
``box_configs`` solver settings, and whether a wider colour class cap
changes it. Needs the card::

    python scripts/exp_pyramid_collapse.py LEVELS[,LEVELS] CONFIG[,CONFIG] \
        FRAMES [knob=value,...]

e.g. ``python scripts/exp_pyramid_collapse.py 30,50 ladder 36`` or
``... 50 ladder,fused 36 gs_cmax=32768``."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

from wgmath_tpu_torch.core import cuda_build  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase  # noqa: E402
from wgmath_tpu_torch.scenes.builders import box_configs, pyramid  # noqa: E402


def main():
    cuda_build.build_all(("gs_math_block", "build_fused", "gs_fused"))
    for L in [int(x) for x in sys.argv[1].split(",")]:
        for name in sys.argv[2].split(","):
            st = pyramid(L, device="cuda")
            n = st.bodies.poses.translation.shape[0]
            y0 = st.bodies.poses.translation[:, 1].clone()
            lvl = torch.zeros(n, dtype=torch.long, device="cuda")
            at = 1
            for l in range(L):
                w = (L - l) ** 2
                lvl[at:at + w] = l
                at += w
            over = {}
            for kv in (sys.argv[4].split(",") if len(sys.argv) > 4 else []):
                k, v = kv.split("=")
                over[k] = int(v)
            cfg = PipelineConfig(**dict(box_configs(n)[name], **over))
            print("config", L, name, over, flush=True)
            t0 = time.time()
            for f in range(int(sys.argv[3])):
                old = cfg
                st, cfg = step_checked(st, SimParams(), cfg)
                ch = [k for k in old.__dataclass_fields__
                      if getattr(old, k) != getattr(cfg, k)]
                if f % 6 == 5 or f == int(sys.argv[3]) - 1:
                    drop = y0 - st.bodies.poses.translation[:, 1]
                    c, need = narrow_phase(st.bodies.poses, st.shapes,
                                           st.bp_pairs,
                                           SimParams().prediction_distance,
                                           p_max=4, with_overflow=True)
                    live = c.valid[:, None] & (torch.arange(4, device="cuda")[None]
                                               < c.num_points[:, None])
                    pen = float(torch.where(live, -c.dist,
                                            torch.zeros_like(c.dist)).max())
                    v = st.bodies.vels.linear
                    comp = [round(float((drop[lvl == l] - 0.01 * l).max()), 3)
                            for l in range(0, L, max(1, L // 8))]
                    pc = st.pair_count.tolist()
                    print(f"L{L} {name} f{f}: pc {pc[:8]} res {pc[8]} drop med "
                          f"{float(drop[1:].median()):.4f} max "
                          f"{float(drop.max()):.4f} lvl0 "
                          f"{float((st.bodies.poses.translation[lvl == 0, 1][1:] - 0.5).abs().max()):.4f} "
                          f"comp {comp} pen {pen:.3f} KE {float((v * v).sum()):.1f} "
                          f"changed {ch} {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
