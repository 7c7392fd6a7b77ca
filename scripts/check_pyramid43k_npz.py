"""Read ``artifacts/pyramid43k.npz`` (the JAX package's recording of the
42.9k-cuboid pyramid, ``scripts/run_pyramid43k.py``: positions every ten
frames from frame 0) and print how far its dynamic bodies have fallen and
moved at each record, beside the free fall of the same number of steps at
4 substeps of 1/240 s. Needs numpy only::

    python scripts/check_pyramid43k_npz.py
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "pyramid43k.npz")
G, H, SUBSTEPS = 9.81, 1.0 / 240.0, 4


def free_fall(steps: int) -> float:
    """The drop of a body in free fall after ``steps`` frames: one velocity
    update and one position update per substep."""
    n = steps * SUBSTEPS
    return G * H * H * n * (n + 1) / 2


def main():
    with np.load(PATH) as z:
        pos, dyn = z["positions"], z["dynamic"].astype(bool)
    p0 = pos[0, dyn]
    for r in range(1, pos.shape[0]):
        steps = 1 + 10 * (r - 1)
        drop = p0[:, 1] - pos[r, dyn, 1]
        moved = np.linalg.norm(pos[r, dyn] - p0, axis=-1)
        print(f"record {r} (after {steps} steps): drop median "
              f"{np.median(drop):.6f} max {drop.max():.6f} m (free fall "
              f"{free_fall(steps):.6f}); moved max {moved.max():.3f} p99 "
              f"{np.percentile(moved, 99):.3f} m")


if __name__ == "__main__":
    main()
