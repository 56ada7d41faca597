"""Parameter and activation sharding over a ("data", "tensor") mesh;
counterpart of ``refiners_tpu/parallel/sharding.py``.

The JAX package annotates arrays and lets GSPMD insert the collectives.
Here the program is explicit SPMD, Megatron's: every rank runs the model on
plain local tensors, and the collectives sit at the edges of each split.

- Tensor parallelism: the same regexes as the JAX package over the same
  dotted ``state_dict()`` paths split the attention and feed-forward
  Linears. A spec names the mesh axis that splits each dimension of a
  tensor in the port's layout: a Linear's weight is (out, in), the
  transpose of the JAX package's (in, out), so JAX's ``P(None, "tensor")``
  is ``("tensor", None)`` here, a column split (`ColumnParallelLinear`,
  local output features), and ``P("tensor", None)`` is ``(None, "tensor")``,
  a row split (`RowParallelLinear`, local input features, one all-reduce).
  The split weights are `DTensor` parameters over the mesh's "tensor" dim,
  so ``state_dict()`` keeps its keys and global shapes, gradients land as
  `DTensor`s, and the optimizers step them shard by shard.
- Attention runs on each rank's heads, with no collective inside it: an
  `Attention` whose head count the tensor size does not divide keeps its
  weights whole (the JAX kernels' partitioning rule replicates such heads).
  A column split whose consumer needs every feature (the GeGLU's gate, which
  pairs the two halves of the features) gathers its output, as GSPMD
  reshards there.
- Data parallelism splits the batch axis over "data" (`DataSharding`); the
  Trainer averages gradients over it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

import refiners_tpu_torch.fluxion.layers as fl

Spec = tuple[str | None, ...]


@dataclass
class PartitionRule:
    """Map state-dict paths (regex over dotted module paths) to a spec: for
    each dimension of the tensor (in the port's layout), the mesh axis that
    splits it, or None."""

    pattern: str
    spec: Spec

    def match(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


# The JAX package's rules, transposed to torch's (out, in) Linear layout:
# - Q/K/V projections (Distribute.Linear_*): split output features, each rank
#   holds a subset of the heads;
# - the output projection after the attention: split input features, then
#   one all-reduce;
# - FeedForward and the GeGLU inside CrossAttentionBlock (Residual_3: d → 8d,
#   4d → d): the first Linear split on its outputs, the second on its inputs.
ATTENTION_TP_RULES: list[PartitionRule] = [
    PartitionRule(r"Distribute\.Linear(_\d+)?\.weight$", ("tensor", None)),
    PartitionRule(r"Distribute\.Linear(_\d+)?\.bias$", ("tensor",)),
    PartitionRule(r"(Attention|SelfAttention|SelfAttention2d)(_\d+)?\.Linear\.weight$", (None, "tensor")),
    PartitionRule(r"(Attention|SelfAttention|SelfAttention2d)(_\d+)?\.Linear\.bias$", ()),
    PartitionRule(r"FeedForward\.Linear_1\.weight$", ("tensor", None)),
    PartitionRule(r"FeedForward\.Linear_1\.bias$", ("tensor",)),
    PartitionRule(r"FeedForward\.Linear_2\.weight$", (None, "tensor")),
    PartitionRule(r"FeedForward\.Linear_2\.bias$", ()),
    PartitionRule(r"Residual_3\.Linear_1\.weight$", ("tensor", None)),
    PartitionRule(r"Residual_3\.Linear_1\.bias$", ("tensor",)),
    PartitionRule(r"Residual_3\.Linear_2\.weight$", (None, "tensor")),
    PartitionRule(r"Residual_3\.Linear_2\.bias$", ()),
]

COLUMN, ROW = ("tensor", None), (None, "tensor")


def infer_partition_spec(path: str, tensor: torch.Tensor, rules: list[PartitionRule]) -> Spec:
    """The spec of the first rule that matches `path`, else () (replicated)."""
    for rule in rules:
        if rule.match(path):
            return rule.spec
    return ()


def _valid_spec(tensor: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> Spec:
    """Drop the axis splits that do not divide the dimension's size."""
    sizes = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
    return tuple(
        None if axis is None or dim >= tensor.ndim or tensor.shape[dim] % sizes[axis] else axis
        for dim, axis in enumerate(spec)
    )


def placement(spec: Spec) -> Shard | Replicate:
    """The `DTensor` placement over the "tensor" dim of a spec."""
    split = [dim for dim, axis in enumerate(spec) if axis is not None]
    if not split:
        return Replicate()
    if len(split) > 1 or spec[split[0]] != "tensor":
        raise ValueError(f"the port splits parameters over the 'tensor' axis only, once: {spec}")
    return Shard(split[0])


# -- split tensors -----------------------------------------------------------------
# c10d collectives on the local shards, not DTensor's redistribution: its
# functional all-gather fails under gloo on CUDA tensors (PERF.md §6).


def local(t: torch.Tensor) -> torch.Tensor:
    """A `DTensor`'s shard on this rank; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def is_split(t: torch.Tensor) -> bool:
    """A `DTensor` whose ranks hold different parts."""
    return isinstance(t, DTensor) and any(p.is_shard() for p in t.placements)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a tensor: a split `DTensor`'s shards gathered (one
    all-gather over its group, which every rank of the group makes), any
    other tensor's local value."""
    if not is_split(t):
        return local(t)
    (place,) = t.placements
    return _all_gather(t.to_local(), place.dim, t.device_mesh.get_group())


def _all_gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The blocks of the ranks of `group` concatenated along `dim` (contiguous)."""
    block = x.movedim(dim, 0).contiguous()
    out = block.new_empty((dist.get_world_size(group) * block.shape[0], *block.shape[1:]))
    dist.all_gather_into_tensor(out, block, group=group)
    return out.movedim(0, dim).contiguous()


def distribute_like(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`whole` placed as `like` is: this rank's shard of it as a `DTensor`
    on `like`'s mesh if `like` is one, else `whole` itself."""
    if not isinstance(like, DTensor):
        return whole
    (place,) = like.placements
    if isinstance(place, Shard):
        mesh = like.device_mesh
        whole = whole.chunk(mesh.size(), dim=place.dim)[mesh.get_local_rank()].clone()
    return DTensor.from_local(whole, like.device_mesh, like.placements, run_check=False)


def sum_over_shards(sums: torch.Tensor, tensors: list[torch.Tensor]) -> torch.Tensor:
    """`sums[i]`, a sum over the local elements of `tensors[i]`, made the
    sum over all its elements: the rows of the split tensors summed over
    their group (one all-reduce a group), in place."""
    rows: dict[dist.ProcessGroup, list[int]] = {}
    for i, t in enumerate(tensors):
        if is_split(t):
            rows.setdefault(t.device_mesh.get_group(), []).append(i)
    for group, index in rows.items():
        at = torch.tensor(index, device=sums.device)
        part = sums.index_select(0, at)
        dist.all_reduce(part, group=group)
        sums.index_copy_(0, at, part)
    return sums


# -- collectives at the edges of a split (Megatron's f, g and their pairs) -----


class _CopyToTensorParallel(torch.autograd.Function):
    """Identity; the backward sums the input gradient over the group."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple[torch.Tensor, None]:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensorParallel(torch.autograd.Function):
    """Sum over the group; the backward passes the gradient through."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple[torch.Tensor, None]:
        return grad, None


def _local_last(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=-1)[dist.get_rank(group)].contiguous()


class _GatherFromTensorParallel(torch.autograd.Function):
    """Concatenate the ranks' features; the backward keeps this rank's."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return _all_gather(x, -1, group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple[torch.Tensor, None]:
        return _local_last(grad, ctx.group), None


class _ScatterToTensorParallel(torch.autograd.Function):
    """Keep this rank's features; the backward concatenates the ranks'."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return _local_last(x, group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple[torch.Tensor, None]:
        return _all_gather(grad, -1, ctx.group), None


class ColumnParallelLinear(fl.Linear):
    """A Linear whose output features are split over the "tensor" dim: its
    weight is a `DTensor` sharded on dim 0 and its bias on dim 0. Takes the
    whole input and gives this rank's output features, or all of them when
    `gather_output`. `shard_module` turns a `fl.Linear` into one in place."""

    tensor_group: dist.ProcessGroup
    gather_output: bool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToTensorParallel.apply(x, self.tensor_group)
        bias = self.bias.to_local().to(x.dtype) if self.bias is not None else None
        out = F.linear(x, self.weight.to_local().to(x.dtype), bias)
        return _GatherFromTensorParallel.apply(out, self.tensor_group) if self.gather_output else out


class RowParallelLinear(fl.Linear):
    """A Linear whose input features are split over the "tensor" dim: its
    weight is a `DTensor` sharded on dim 1, its bias replicated. Takes this
    rank's input features (or all of them, keeping its own, unless
    `input_is_parallel`), sums the partial products over the group, then
    adds the bias."""

    tensor_group: dist.ProcessGroup
    input_is_parallel: bool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = _ScatterToTensorParallel.apply(x, self.tensor_group)
        out = _ReduceFromTensorParallel.apply(F.linear(x, self.weight.to_local().to(x.dtype)), self.tensor_group)
        return out + self.bias.to_local().to(out.dtype) if self.bias is not None else out


# -- placing a module on a mesh -------------------------------------------------------


def broadcast_from_first(tensors: list[torch.Tensor], mesh: DeviceMesh) -> None:
    """Give every rank of the mesh the first rank's values, in place: over
    each "tensor" group, then over each "data" group."""
    for axis in ("tensor", "data"):
        group = mesh.get_group(axis)
        if dist.get_world_size(group) == 1:
            continue
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def _projections(attention: fl.Attention) -> tuple[fl.Distribute, fl.Linear] | None:
    """The Q/K/V projections and the output projection of a `bare_attention`."""
    layers = list(attention)
    at = [i for i, layer in enumerate(layers) if isinstance(layer, fl.ScaledDotProductAttention)]
    if len(at) != 1 or not 0 < at[0] < len(layers) - 1:
        return None
    qkv, out = layers[at[0] - 1], layers[at[0] + 1]
    return (qkv, out) if isinstance(qkv, fl.Distribute) and isinstance(out, fl.Linear) else None


def bare_attention(attention: fl.Attention) -> bool:
    """Its projections feed the scaled dot-product attention and that the
    output projection directly: no adapter's layer between them (SAG's
    attention map, StyleAligned's reference features), which would read all
    the heads' features."""
    return _projections(attention) is not None


def _splits(module: fl.Module, mesh: DeviceMesh, rules: list[PartitionRule]) -> dict[fl.Linear, Spec]:
    """The Linears whose weight the rules split by columns or rows, where the
    dimension divides; an attention's projections only together, only where
    the tensor size divides its heads, and only in a `bare_attention`."""
    splits: dict[fl.Linear, Spec] = {}
    for path, linear in module.named_modules():
        if isinstance(linear, fl.Linear):
            spec = _valid_spec(linear.weight, infer_partition_spec(f"{path}.weight", linear.weight, rules), mesh)
            if spec in (COLUMN, ROW):
                splits[linear] = spec
            elif any(axis is not None for axis in spec):
                raise ValueError(f"{path}.weight: the port splits Linears by whole columns or rows, not {spec}")
    tensor = mesh["tensor"].size()
    for attention in module.modules():
        if isinstance(attention, fl.Attention):
            projections = None if attention.num_heads % tensor else _projections(attention)
            split = projections is not None and (
                all(splits.get(q) == COLUMN for q in projections[0]) and splits.get(projections[1]) == ROW
            )
            if not split:
                for linear in attention.modules():
                    splits.pop(linear, None)  # type: ignore[call-overload]
    return splits


def _plan(chain: fl.Chain, splits: dict[fl.Linear, Spec]) -> None:
    """Decide, chain by chain, where a column split's local features flow:
    into the heads of an attention, through an elementwise activation, into
    a row split (kept local), or into anything else (gathered first)."""
    local: list[fl.Linear] = []  # the column splits whose local output flows here

    def gather() -> None:
        for producer in local:
            producer.gather_output = True
        local.clear()

    for layer in chain:
        if isinstance(layer, fl.Linear) and splits.get(layer) == COLUMN:
            gather()
            local.append(layer)
            layer.gather_output = False
        elif isinstance(layer, fl.Distribute) and layer and all(splits.get(m) == COLUMN for m in layer):
            gather()
            local.extend(layer)
            for linear in layer:
                linear.gather_output = False
        elif isinstance(layer, fl.Linear) and splits.get(layer) == ROW:
            layer.input_is_parallel = bool(local)
            local.clear()
        elif isinstance(layer, fl.ScaledDotProductAttention) or (
            isinstance(layer, fl.Activation) and not isinstance(layer, fl.GLU)
        ):
            continue  # per head, per feature: local features stay local
        else:
            gather()
            if isinstance(layer, fl.Chain):
                _plan(layer, splits)
    gather()  # a chain's output is whole


def shard_module(module: fl.Module, mesh: DeviceMesh, rules: list[PartitionRule] | None = None) -> None:
    """Place every parameter of `module` on the mesh, in place: the first
    rank's values on every rank (one broadcast per tensor and mesh dim),
    then the Linears the TP rules match split over "tensor" as `DTensor`s
    (with a tensor size of 1 nothing is split). A split Linear's bias
    follows its weight: split with a column split's outputs, whole beside a
    row split. Every rank of the process group calls it; on a rank outside
    the mesh it does nothing. The module must already be on the mesh's
    device type: a mesh on cuda never runs a module on the CPU."""
    rules = rules if rules is not None else ATTENTION_TP_RULES
    tensors = [*module.parameters(), *module.buffers()]
    if any(isinstance(t, DTensor) for t in tensors):
        raise ValueError(f"{type(module).__name__} is already sharded")
    wrong = {t.device.type for t in tensors} - {mesh.device_type}
    if wrong:
        raise ValueError(f"the mesh is on {mesh.device_type}, the module has tensors on {sorted(wrong)}")
    if mesh.get_coordinate() is None:
        return
    with torch.no_grad():
        broadcast_from_first([t.data for t in tensors], mesh)
    tensor_mesh = mesh["tensor"]
    if tensor_mesh.size() == 1 or not rules:
        return
    splits = _splits(module, mesh, rules)
    if not splits:
        return
    group, rank, size = tensor_mesh.get_group(), tensor_mesh.get_local_rank(), tensor_mesh.size()
    for linear, spec in splits.items():
        for name, place in (("weight", placement(spec)), ("bias", placement(spec[:1]))):
            p = getattr(linear, name)
            if p is None:
                continue
            local = p.detach().chunk(size, dim=place.dim)[rank].clone() if isinstance(place, Shard) else p.detach()
            dt = DTensor.from_local(local, tensor_mesh, [place], run_check=False)
            setattr(linear, name, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
        linear.__class__ = ColumnParallelLinear if spec == COLUMN else RowParallelLinear
        linear.tensor_group = group
        linear.gather_output = True  # until `_plan` finds a consumer of local features
        linear.input_is_parallel = False
    # by identity: a structural copy of an attention shares its scaled dot-product attention (reference-only's
    # guided self-attention), whose heads are split once
    split_sdpa: dict[int, fl.ScaledDotProductAttention] = {}
    for attention in module.modules():
        if isinstance(attention, fl.Attention) and splits.get(attention.layer("Linear", fl.Linear)) == ROW:
            sdpa = attention.layer("ScaledDotProductAttention", fl.ScaledDotProductAttention)
            split_sdpa[id(sdpa)] = sdpa
    for sdpa in split_sdpa.values():
        sdpa.num_heads //= size
    for chain in _outermost_chains(module):
        _plan(chain, splits)


def gather_attention(attention: fl.Attention) -> None:
    """Put a tensor-split attention back whole, in place, as `shard_module`
    leaves an attention that is not `bare_attention`: each split Linear's
    weight and bias gathered into a plain replicated parameter (one
    all-gather per split tensor over its "tensor" group, which every rank of
    the group makes), the Linear a plain `fl.Linear` again, and the scaled
    dot-product attention on all the heads."""
    size = 1
    for linear in attention.modules():
        if not isinstance(linear, (ColumnParallelLinear, RowParallelLinear)):
            continue
        size = linear.weight.device_mesh.size()
        # plain tensors even under `torch.inference_mode()`, where the loop checks the UNet
        with torch.inference_mode(False), torch.no_grad():
            for name in ("weight", "bias"):
                p = getattr(linear, name)
                if p is not None:
                    setattr(linear, name, torch.nn.Parameter(full(p.detach()), requires_grad=p.requires_grad))
        linear.__class__ = fl.Linear
        del linear.tensor_group, linear.gather_output, linear.input_is_parallel
    attention.layer("ScaledDotProductAttention", fl.ScaledDotProductAttention).num_heads *= size


def _outermost_chains(module: torch.nn.Module) -> list[fl.Chain]:
    if isinstance(module, fl.Chain):
        return [module]
    return [chain for child in module.children() for chain in _outermost_chains(child)]


def replicate_module(module: fl.Module, mesh: DeviceMesh) -> None:
    shard_module(module, mesh, rules=[])


@dataclass(frozen=True)
class DataSharding:
    """A tensor's batch axis split over the mesh's "data" dim: `shard` gives
    this rank's block of rows, `gather` puts the blocks back together on
    every rank (no gradient)."""

    mesh: DeviceMesh
    ndim: int
    batch_axis: int = 0

    @property
    def size(self) -> int:
        # by index, not `mesh["data"]`: a sub-mesh is built anew at each slicing, about 0.25 ms of host time
        return self.mesh.size(self.mesh.mesh_dim_names.index("data"))

    def divides(self, x: torch.Tensor) -> bool:
        return x.ndim == self.ndim and x.shape[self.batch_axis] % self.size == 0

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        assert self.divides(x), f"a batch of {x.shape[self.batch_axis]} does not split over data={self.size}"
        rows = x.shape[self.batch_axis] // self.size
        return x.narrow(self.batch_axis, self.mesh.get_local_rank("data") * rows, rows)

    @torch.no_grad()
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _all_gather(x, self.batch_axis, self.mesh.get_group("data"))


def data_sharding(mesh: DeviceMesh, ndim: int, batch_axis: int = 0) -> DataSharding:
    """Shard the batch axis over "data", replicate the rest."""
    return DataSharding(mesh, ndim, batch_axis)
