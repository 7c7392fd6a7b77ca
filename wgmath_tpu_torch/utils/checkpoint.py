"""Checkpoint and resume of a physics state (counterpart of
``wgmath_tpu/utils/checkpoint.py``).

:func:`save` writes ``convert.state_to_arrays`` with ``torch.save``;
:func:`load` rebuilds the state with ``convert.state_from_arrays``. Every
tensor of a state is int64, bool or float32, which is what
``state_from_arrays`` makes, so a round trip returns the state bit for bit:
the bodies and shapes, the joints, the broad-phase cache and its colours,
last frame's constraints and colours and the solve cache
(``tests/test_torch_testbed.py`` holds each tensor's dtype, shape and
bytes).
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays

FORMAT = 1


def save(path: str, state) -> None:
    """Write ``state`` (a ``pipeline.PhysicsState``) to ``path``."""
    torch.save({"format": FORMAT, "arrays": state_to_arrays(state)}, path)


def load(path: str, device=None):
    """The state :func:`save` wrote, on ``device`` (``None``: the card)."""
    blob = torch.load(path, weights_only=False)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of format {FORMAT}")
    return state_from_arrays(blob["arrays"], device)
