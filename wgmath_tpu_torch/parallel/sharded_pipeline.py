"""The full pipeline across ranks: a replicated state and sharded work
(counterpart of ``wgmath_tpu/parallel/sharded_pipeline.py``).

Every rank of a ``torch.distributed`` group holds the whole
``PhysicsState`` and runs ``pipeline.step`` with ``shard=(group, n)``:
each rank takes a row block of the broad phase, a block of the pair slots
in the narrow phase and a slice of every colour of the Gauss-Seidel
sweep; the pairs, the contacts and each colour's velocity deltas and
impulses are exchanged (two all-gathers a frame, the first only on a
broad-phase refresh, and one all-reduce a colour a sweep). Everything
else (the broad-phase cache, the colouring, the compaction, the warmstart,
the joints, the integration) runs replicated: every op on that path is
deterministic on a given device, so the ranks' states stay equal bit for
bit. The step accepts the same ``PipelineConfig`` as the single-device
step and gives its results (``pair_capacity`` must be a multiple of the
rank count).

    import torch.distributed as dist
    dist.init_process_group("nccl")  # one GPU a rank, as torchrun starts
    state = replicate_state(state)
    run = make_sharded_step(None, params, config)
    state = run(state)
"""

from __future__ import annotations

from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PhysicsState, PipelineConfig, step


def replicate_state(state: PhysicsState, group=None,
                    device=None) -> PhysicsState:
    """The group's first rank's ``state`` on every rank of ``group``
    (``None``: the default group), on ``device`` (default: the device of
    this rank's ``state``). The state travels as
    ``convert.state_to_arrays`` in one ``broadcast_object_list``, and every
    rank, the first included, rebuilds it with ``state_from_arrays``, so
    the copies are equal bit for bit."""
    import torch.distributed as dist

    box = [state_to_arrays(state)]
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast_object_list(box, src=src, group=group)
    if device is None:
        device = state.bodies.poses.translation.device
    return state_from_arrays(box[0], device)


def make_sharded_step(group, params: SimParams, config: PipelineConfig, *,
                      n_steps: int = 1):
    """``fn(state) -> state`` advancing ``n_steps`` frames with the whole
    pipeline split across the ranks of ``group`` (``None``: the default
    group). Call it on every rank with the same replicated state
    (:func:`replicate_state`)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if config.pair_capacity % n:
        raise ValueError(f"pair_capacity {config.pair_capacity} must be a "
                         f"multiple of the rank count {n}")
    shard = (group, n)

    def run(state: PhysicsState) -> PhysicsState:
        for _ in range(n_steps):
            state = step(state, params, config, warmstart=True, shard=shard)
        return state

    return run
