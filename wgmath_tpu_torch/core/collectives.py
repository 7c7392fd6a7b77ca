"""The collectives of the sharded step (the JAX package's ``shard_map``
collectives over ``torch.distributed``).

A shard is ``(group, n_ranks)``, the counterpart of JAX's ``(axis_name,
n_devices)``: ``group`` is a ``torch.distributed`` process group (``None``
for the default group) of ``n_ranks`` ranks, each running the same step
on a replicated state. The JAX collectives map as

- ``axis_index``: ``dist.get_rank(group)`` (:attr:`Shard.rank`);
- the tiled ``all_gather``: ``dist.all_gather`` on a list, then
  ``torch.cat`` (:func:`all_gather_cat`);
- ``psum`` / ``pmax``: ``all_reduce(SUM)`` (:func:`all_reduce_sum`), or a
  gathered vector reduced on every rank alike.

Only ``all_gather`` (list form), ``all_reduce`` and ``broadcast_object_list``
are used: gloo and NCCL both take them, on CPU and CUDA tensors (gloo
stages a CUDA tensor through the host). Gloo takes no bool tensors, so
masks travel as int64. ``COLLECTIVES`` / ``BYTES`` count the calls and the
bytes of their results on this rank (an all-gather's whole gathered
tensor, an all-reduce's buffer), for a run's accounting.
"""

from __future__ import annotations

import dataclasses

import torch

COLLECTIVES = 0
BYTES = 0


@dataclasses.dataclass(frozen=True)
class Shard:
    """An initialised process group as the step sees it."""

    group: object
    n: int
    rank: int


def resolve(shard) -> Shard | None:
    """``(group, n_ranks)`` → :class:`Shard`, after checking that a process
    group is initialised and holds ``n_ranks`` ranks (``None`` stays
    ``None``). Raises ``ValueError`` otherwise."""
    if shard is None or isinstance(shard, Shard):
        return shard
    import torch.distributed as dist

    try:
        group, n = shard
    except (TypeError, ValueError):
        raise ValueError(f"shard must be (group, n_ranks), got {shard!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("shard: no torch.distributed process group is "
                         "initialised (start the ranks as torchrun does and "
                         "call init_process_group first)")
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise ValueError(f"shard: {group!r} is not a process group")
    size = dist.get_world_size(group)
    if size != n:
        raise ValueError(f"shard: the group holds {size} ranks, not {n}")
    return Shard(group, int(n), dist.get_rank(group))


def _count(nbytes: int) -> None:
    global COLLECTIVES, BYTES
    COLLECTIVES += 1
    BYTES += int(nbytes)


def all_gather_cat(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order: JAX's tiled ``all_gather``."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.n)]
    dist.all_gather(parts, x, group=shard.group)
    _count(x.numel() * x.element_size() * shard.n)
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``x`` summed over the ranks, in place (JAX's ``psum``)."""
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=shard.group)
    _count(x.numel() * x.element_size())
    return x


def gather_fields(tensors: list, shard: Shard) -> list:
    """All-gather a list of tensors with equal leading sizes along dim 0,
    one collective per dtype class: reals in one float32 buffer, integers
    and masks in one int64 buffer (each row flattened and the rows laid
    side by side), then split back to their shapes and dtypes."""
    groups = {}
    for i, t in enumerate(tensors):
        key = torch.float32 if t.is_floating_point() else torch.int64
        groups.setdefault(key, []).append(i)
    out = [None] * len(tensors)
    for dtype, idx in groups.items():
        rows = tensors[idx[0]].shape[0]
        flat = [tensors[i].reshape(rows, -1).to(dtype) for i in idx]
        widths = [f.shape[1] for f in flat]
        got = all_gather_cat(torch.cat(flat, dim=1), shard)
        col = 0
        for i, w in zip(idx, widths):
            t = tensors[i]
            out[i] = got[:, col:col + w].reshape(
                (got.shape[0],) + tuple(t.shape[1:])).to(t.dtype)
            col += w
    return out
