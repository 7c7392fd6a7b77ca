"""Scale-out over ``torch.distributed`` (counterpart of
``wgmath_tpu/parallel``): the round-1 body-sharded step
(:mod:`~wgmath_tpu_torch.parallel.sharded`) and the full pipeline with a
replicated state and sharded work
(:mod:`~wgmath_tpu_torch.parallel.sharded_pipeline`).

The package starts no processes: a user starts the ranks as ``torchrun``
does (one process a rank, ``init_process_group`` called in each) and
hands the step a group that is already initialised."""

from wgmath_tpu_torch.parallel.sharded import (  # noqa: F401
    body_mesh,
    make_sharded_step,
    shard_state,
)
