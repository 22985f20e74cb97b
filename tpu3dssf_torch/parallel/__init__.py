"""Data, tensor and sequence parallelism over ``torch.distributed`` (port of
``tpu3dssf.parallel``): the names the JAX package exports, and the
:class:`Mesh` that ``create_mesh`` returns and :func:`pick_backend`, its
choice of backend by layout (NCCL where each rank has a card, gloo on the
CPU), but ``batch_sharding`` / ``replicated_sharding``, which place arrays
for XLA and have no caller in the port."""

from tpu3dssf_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    pick_backend,
    replicate,
    shard_batch,
    vit_tp_shardings,
)
from tpu3dssf_torch.parallel.sp import sp_block_apply

__all__ = [
    "Mesh",
    "create_mesh",
    "pick_backend",
    "shard_batch",
    "replicate",
    "vit_tp_shardings",
    "sp_block_apply",
]
