"""Data parallelism over ``torch.distributed`` ranks (ROADMAP slice 6), the
counterpart of ``pnode_tpu/parallel``: a ``DeviceMesh`` for JAX's ``Mesh``,
batch-sharded training with one gradient mean per step, the fused loop's
data-parallel form (K12 per rank), and ``run_ranks``, which spawns a group
of ranks on one machine."""

from .data_parallel import (
    dp_value_and_grad,
    make_mesh,
    replicate,
    run_ranks,
    shard_batch,
)
from .fused_dp import dp_fused_train_loop

__all__ = ["make_mesh", "shard_batch", "replicate", "dp_value_and_grad",
           "dp_fused_train_loop", "run_ranks"]
