"""Device mesh construction; counterpart of ``refiners_tpu/parallel/mesh.py``.

The JAX package builds a `jax.sharding.Mesh` over the devices of one
program and lets GSPMD insert the collectives. Here each card is a process
(`torchrun --nproc-per-node=<cards>`), and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` of shape (data, tensor) with
dims named ("data", "tensor") over the ranks of the process group that is
already running: NCCL on the card, gloo when the caller asks for the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_AXES = ("data", "tensor")


def init_process_group(
    backend: str = "nccl",
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: datetime.timedelta | None = None,
) -> None:
    """Join the process group that `torchrun` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or the one
    given by `init_method`, `rank` and `world_size` (a ``file://`` store,
    say). With NCCL each process takes the card of its ``LOCAL_RANK`` (else
    its rank modulo the cards). `timeout` bounds each collective (torch's
    default otherwise). Does nothing if the group is already up."""
    if dist.is_initialized():
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device; pass backend='gloo' for the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=world_size, timeout=timeout
    )


def make_mesh(
    data: int | None = None, tensor: int = 1, device_type: str | None = None, ranks: Sequence[int] | None = None
) -> DeviceMesh:
    """Build a ("data", "tensor") mesh over `ranks` (default: every rank of
    the process group), rank-major: the ranks of one data row are
    consecutive and form a "tensor" group. `data=None` puts every remaining
    rank on the data axis. `device_type` is ``"cuda"`` unless the caller
    asks for ``"cpu"``. Every rank of the process group calls this (the
    mesh's groups are made collectively); a rank outside `ranks` gets a mesh
    whose ``get_coordinate()`` is None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.init_process_group() first (torchrun)")
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on cuda needs a CUDA device; pass device_type='cpu' for the CPU")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    if data is None:
        assert n % tensor == 0, f"{n} devices not divisible by tensor={tensor}"
        data = n // tensor
    assert data * tensor == n, f"mesh {data}x{tensor} != {n} devices"
    return DeviceMesh(device_type, torch.tensor(ranks).view(data, tensor), mesh_dim_names=MESH_AXES)
