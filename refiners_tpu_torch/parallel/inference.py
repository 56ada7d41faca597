"""Mesh-aware latent-diffusion inference (DP over the batch and the CFG pair,
optional TP); counterpart of ``refiners_tpu/parallel/inference.py``.

`shard_latent_diffusion` places a model on a ("data", "tensor") mesh once:
the UNet's attention and feed-forward Linears split by `ATTENTION_TP_RULES`,
everything else (convolutions, time embeddings, the VAE, the text encoder,
the solver's tables) the same on every rank. The model then splits each
step's CFG batch over "data" (`LatentDiffusionModel.predict_noise`,
`run_unet`): each rank runs its rows of the UNet, one all-gather of the
noise prediction follows, and the guidance and the solver step run on
every rank. A layer that reads other rows than its own (StyleAligned's
reference, reference-only control's unconditional mix) is told this rank's
rows for the call and gathers what it reads (`_rows_coupled`); an adapter
entered into a split attention after the placement gets that attention
back whole (`_check`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch
from torch.distributed.device_mesh import DeviceMesh

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.parallel.sharding import (
    ATTENTION_TP_RULES,
    DataSharding,
    PartitionRule,
    RowParallelLinear,
    bare_attention,
    data_sharding,
    gather_attention,
    replicate_module,
    shard_module,
)

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel

logger = logging.getLogger(__name__)


def shard_latent_diffusion(
    sd: "LatentDiffusionModel",
    mesh: DeviceMesh,
    tp_rules: list[PartitionRule] | None = None,
) -> None:
    """Place a LatentDiffusionModel on `mesh` in place: the UNet by the TP
    rules, the VAE, the text encoder and the solver replicated. The model
    keeps the mesh and splits its CFG batch over "data" from then on."""
    shard_module(sd.unet, mesh, tp_rules if tp_rules is not None else ATTENTION_TP_RULES)
    replicate_module(sd.lda, mesh)
    replicate_module(sd.clip_text_encoder, mesh)
    replicate_module(sd.solver, mesh)
    sd.mesh = mesh


def batch_sharding(mesh: DeviceMesh, ndim: int = 4) -> DataSharding:
    """Sharding for latent / embedding inputs: batch over "data"."""
    return data_sharding(mesh, ndim)


def shard_inputs(mesh: DeviceMesh, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each tensor's block of rows for this rank, its leading (batch) axis
    split over the "data" mesh axis; a tensor whose batch does not divide
    the data-axis size (a single shared time_ids row, say) stays whole."""
    out: list[torch.Tensor] = []
    for t in tensors:
        sharding = data_sharding(mesh, t.ndim)
        out.append(sharding.shard(t) if t.ndim >= 1 and sharding.divides(t) else t)
    return tuple(out)


@dataclass(frozen=True)
class RowBlock:
    """This rank's block of a batch split over "data", as a row-coupled
    layer sees it during `run_unet`: rows [start, start + rows) of `total`;
    `gather` puts a tensor's blocks back together on every rank (one
    all-gather over "data", which every rank makes)."""

    sharding: DataSharding
    start: int
    rows: int
    total: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.sharding.gather(x)


def _rows_coupled() -> tuple[type[fl.Module], ...]:
    """The layers that compute on other rows of the CFG batch than their own,
    or on a row's place in it, and that take this rank's `RowBlock` in their
    `row_block` for a split call: StyleAligned's reference features (each
    half's first sample, gathered where it lies on another rank) and their
    scaling (all but each half's first), reference-only control's mix of the
    first (unconditional) sample."""
    from refiners_tpu_torch.foundationals.latent_diffusion.reference_only_control import (
        SelfAttentionInjectionAdapter,
    )
    from refiners_tpu_torch.foundationals.latent_diffusion.style_aligned import (
        ExtractReferenceFeatures,
        ScaleReferenceFeatures,
    )

    return (ExtractReferenceFeatures, ScaleReferenceFeatures, SelfAttentionInjectionAdapter)


def _check(unet: fl.Chain, split_rows: bool) -> None:
    """Make the UNet fit for the mesh, at a denoising loop's first step.
    Under a row split, raise on a layer that reads other rows of the batch
    than its own (a class attribute ``reads_other_rows = True`` says so)
    and is not one of `_rows_coupled`. Put back whole (`gather_attention`)
    every tensor-split attention (output projection row-parallel) that an
    adapter entered after `shard_module` (SAG's map, StyleAligned: they
    would see this rank's heads only), as if the adapter had been injected
    before the placement, and log which, once, at warning."""
    handled = _rows_coupled()
    put_back: list[str] = []
    for name, module in unet.named_modules():
        if split_rows and getattr(module, "reads_other_rows", False) and not isinstance(module, handled):
            raise ValueError(
                f"{type(module).__name__} reads other rows of the CFG batch than its own and the mesh does not "
                "give it them: run it on a mesh with data = 1, or split the batch where it does not reach this layer"
            )
        if isinstance(module, fl.Attention) and not bare_attention(module):
            if isinstance(list(module)[-1], RowParallelLinear):
                gather_attention(module)
                put_back.append(name or type(module).__name__)
    if put_back:
        logger.warning(
            "an adapter entered %d tensor-split attention(s) after the split; put back whole: %s",
            len(put_back), ", ".join(put_back),
        )  # fmt: skip


def _walk(unet: fl.Chain) -> tuple[list[tuple[str, dict[str, Any]]], list[fl.Module]]:
    """Every distinct context dict that the chains under `unet` read, by
    context name, and the `_rows_coupled` layers under it. `Chain.set_context`
    replaces the dict at the chain it is called on and updates the other
    chains' own copies in place, so a chain's copy can hold keys that the
    UNet's lacks (SDXL's "diffusion" context: the UNet's holds only the key
    set last)."""
    coupled_types = _rows_coupled()
    seen: dict[int, tuple[str, dict[str, Any]]] = {}
    coupled: list[fl.Module] = []
    stack: list[torch.nn.Module] = [unet]
    while stack:
        module = stack.pop()
        if isinstance(module, coupled_types):
            coupled.append(module)
        if isinstance(module, fl.Chain):
            for name, values in module.provider.contexts.items():
                seen.setdefault(id(values), (name, values))
        stack.extend(module._modules.values())
    return list(seen.values()), coupled


# What the UNet writes in its contexts by rows and its caller reads after it:
# (context, key). SAG's middle-block attention map, read for the mask.
ROW_OUTPUTS = [("self_attention_map", "middle_block_attn_map")]


def run_unet(unet: fl.Chain, mesh: DeviceMesh, latents: torch.Tensor, check: bool = True) -> torch.Tensor:
    """The UNet's prediction for `latents`, its contexts already set, on every
    rank of `mesh`. Where the "data" size divides the batch, each rank runs
    its block of rows: every tensor of the contexts that the UNet's chains
    read (`_context_dicts`) whose leading axis is the batch (the text
    embeddings, SDXL's pooled embedding and time ids, an IP-Adapter's image
    tokens, a per-row condition) is cut to the same rows for the call and
    put back after, and what the call leaves
    in the contexts by rows for its caller (`ROW_OUTPUTS`: SAG's attention
    map) is gathered, as the prediction is. The `_rows_coupled` layers get
    this rank's `RowBlock` for the call. A batch that does not divide runs
    whole on every rank. With `check`, makes the UNet fit for the split
    (`_check`: a walk of the whole tree, a few ms of host time, so a
    denoising loop checks at its first step)."""
    sharding = data_sharding(mesh, latents.ndim)
    split_rows = sharding.size > 1 and sharding.divides(latents)
    tensor = mesh.size(mesh.mesh_dim_names.index("tensor"))
    if check and (split_rows or tensor > 1):
        _check(unet, split_rows)
    if not split_rows:
        return unet(latents)
    batch = latents.shape[0]
    rows = batch // sharding.size
    contexts, coupled = _walk(unet)
    block = RowBlock(sharding, mesh.get_local_rank("data") * rows, rows, batch)
    for layer in coupled:
        layer.row_block = block
    cut: list[tuple[dict[str, Any], str, torch.Tensor, torch.Tensor]] = []
    for _, values in contexts:
        for key, value in values.items():
            if isinstance(value, torch.Tensor) and value.ndim >= 1 and value.shape[0] == batch:
                part = data_sharding(mesh, value.ndim).shard(value)
                values[key] = part
                cut.append((values, key, value, part))
    try:
        prediction = unet(sharding.shard(latents))
    finally:
        for values, key, whole, part in cut:
            if values.get(key) is part:
                values[key] = whole
        for layer in coupled:
            layer.row_block = None
    assert prediction.shape[0] == rows, f"the UNet gave {prediction.shape[0]} rows for {rows}"
    gathered: dict[int, torch.Tensor] = {}
    for name, values in contexts:
        for context, key in ROW_OUTPUTS:
            value = values.get(key) if name == context else None
            if isinstance(value, torch.Tensor) and value.shape[0] == rows:
                if id(value) not in gathered:
                    gathered[id(value)] = data_sharding(mesh, value.ndim).gather(value)
                values[key] = gathered[id(value)]
    return sharding.gather(prediction)
