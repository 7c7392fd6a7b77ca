"""Pose-trajectory rendering for the testbed (counterpart of
``wgmath_tpu/testbed/viewer.py``): matplotlib scatter frames and a GIF
from recorded poses.

- :class:`Recorder`: the runner accumulates each frame's translations and
  each body's draw size and static flag, and writes one ``.npz``;
- :func:`render_npz` / :func:`render_frames`: a recording to PNG frames
  and, with pillow, an animated GIF (``python -m
  wgmath_tpu_torch.testbed.viewer PATH.npz --out-dir frames --gif
  out.gif``).

matplotlib is imported inside the functions that draw, and raises a clear
error where it is absent; the simulation never imports it.
"""

from __future__ import annotations

import os

import numpy as np


def body_draw_meta(state):
    """Each body's draw size (the mean half-extent of its world box at the
    recorded first frame: every shape becomes a blob of that radius) and
    its dynamic flag, from a ``PhysicsState``."""
    from wgmath_tpu_torch.shapes.shape import world_aabbs

    mins, maxs = world_aabbs(state.shapes, state.bodies.poses)
    half = ((maxs - mins) / 2.0).detach().cpu().numpy()
    dynamic = state.bodies.is_dynamic().cpu().numpy()
    return half.mean(axis=-1), dynamic


class Recorder:
    """Accumulates translations each frame; saves one compressed npz."""

    def __init__(self, state):
        self.size, self.dynamic = body_draw_meta(state)
        self.frames: list[np.ndarray] = []

    def record(self, state) -> None:
        self.frames.append(state.bodies.poses.translation.detach().cpu()
                           .numpy().astype(np.float32))

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, positions=np.stack(self.frames), size=self.size,
            dynamic=self.dynamic)


def _render_scatter(ax, pos, size, dynamic, lims, dim):
    # statics gray, dynamics colored by height (the up axis is y for 3D
    # scenes and y for 2D — scene builders' convention)
    up = pos[:, 1]
    # matplotlib scatter s is points^2; scale sizes to the scene extent.
    # Huge statics (the ground slab) cap at 10% of the view so they read
    # as markers instead of swallowing the frame.
    extent = max(lims[1] - lims[0], 1e-6)
    s = np.clip(size, 1e-3, 0.1 * extent)
    pts = (s / extent * 340.0) ** 2
    if dim == 3:
        stat, dyn = ~dynamic, dynamic
        ax.scatter(pos[stat, 0], pos[stat, 2], pos[stat, 1], s=pts[stat],
                   c="#888888", alpha=0.35, depthshade=False)
        ax.scatter(pos[dyn, 0], pos[dyn, 2], pos[dyn, 1], s=pts[dyn],
                   c=up[dyn], cmap="viridis", alpha=0.9, depthshade=True)
        ax.set_xlim(lims); ax.set_ylim(lims); ax.set_zlim(lims)
        ax.set_box_aspect((1, 1, 1))
    else:
        stat, dyn = ~dynamic, dynamic
        ax.scatter(pos[stat, 0], pos[stat, 1], s=pts[stat], c="#888888",
                   alpha=0.35)
        ax.scatter(pos[dyn, 0], pos[dyn, 1], s=pts[dyn], c=up[dyn],
                   cmap="viridis", alpha=0.9)
        ax.set_xlim(lims); ax.set_ylim(lims)
        ax.set_aspect("equal")


def render_frames(positions, size, dynamic, out_dir: str, *, every: int = 1,
                  gif: str | None = None, dpi: int = 90):
    """Render recorded positions ([F, N, dim]) to PNGs (and optional GIF).

    Returns the list of written PNG paths.
    """
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "rendering needs matplotlib (not installed)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    positions = np.asarray(positions)
    dynamic = np.asarray(dynamic, bool)
    f, n, dim = positions.shape
    lo = positions.reshape(-1, dim).min(axis=0).min()
    hi = positions.reshape(-1, dim).max(axis=0).max()
    pad = 0.05 * (hi - lo + 1e-6)
    lims = (float(lo - pad), float(hi + pad))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(0, f, max(every, 1)):
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(
            111, projection="3d" if dim == 3 else None)
        _render_scatter(ax, positions[i], size, dynamic, lims, dim)
        ax.set_title(f"frame {i}")
        p = os.path.join(out_dir, f"frame_{i:05d}.png")
        fig.savefig(p, dpi=dpi)
        plt.close(fig)
        paths.append(p)
    if gif and paths:
        try:
            from PIL import Image

            imgs = [Image.open(p) for p in paths]
            imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                         duration=60, loop=0)
        except ImportError:  # pragma: no cover
            pass
    return paths


def render_npz(npz_path: str, out_dir: str, *, every: int = 1,
               gif: str | None = None):
    """Render a runner ``--record`` npz to PNG frames (CLI helper)."""
    data = np.load(npz_path)
    return render_frames(data["positions"], data["size"], data["dynamic"],
                         out_dir, every=every, gif=gif)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="render a testbed --record trajectory to PNG/GIF")
    ap.add_argument("recording", help="npz from testbed.runner --record")
    ap.add_argument("--out-dir", default="frames")
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--gif", default=None)
    args = ap.parse_args(argv)
    paths = render_npz(args.recording, args.out_dir, every=args.every,
                       gif=args.gif)
    print(f"wrote {len(paths)} frames to {args.out_dir}"
          + (f" + {args.gif}" if args.gif else ""))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
