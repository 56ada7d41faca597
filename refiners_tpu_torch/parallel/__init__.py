"""Parallelism and memory levers; counterpart of ``refiners_tpu/parallel/``.

- ``mesh``: `make_mesh`, a ("data", "tensor") `DeviceMesh` over the ranks
  of a running process group (`init_process_group` joins the one `torchrun`
  describes);
- ``sharding``: the tensor-parallel rules (`ATTENTION_TP_RULES`), placing a
  module on the mesh (`shard_module`, `replicate_module`) and the batch
  split over "data" (`data_sharding`);
- ``inference``: `shard_latent_diffusion`, `batch_sharding`, `shard_inputs`;
- ``remat``: rematerialization (`Recompute`, `apply_remat`, `remove_remat`).
"""

from refiners_tpu_torch.parallel.inference import batch_sharding, shard_inputs, shard_latent_diffusion
from refiners_tpu_torch.parallel.mesh import init_process_group, make_mesh
from refiners_tpu_torch.parallel.remat import Recompute, apply_remat, remove_remat
from refiners_tpu_torch.parallel.sharding import (
    ATTENTION_TP_RULES,
    PartitionRule,
    data_sharding,
    infer_partition_spec,
    replicate_module,
    shard_module,
)

__all__ = [
    "Recompute",
    "apply_remat",
    "remove_remat",
    "make_mesh",
    "ATTENTION_TP_RULES",
    "PartitionRule",
    "batch_sharding",
    "data_sharding",
    "infer_partition_spec",
    "replicate_module",
    "shard_inputs",
    "shard_latent_diffusion",
    "shard_module",
]
