"""Mesh-aware latent-diffusion inference (DP over the batch and the CFG pair,
optional TP); counterpart of ``refiners_tpu/parallel/inference.py``.

`shard_latent_diffusion` places a model on a ("data", "tensor") mesh once:
the UNet's attention and feed-forward Linears split by `ATTENTION_TP_RULES`,
everything else (convolutions, time embeddings, the VAE, the text encoder,
the solver's tables) the same on every rank. The model then splits each
step's CFG batch over "data" (`LatentDiffusionModel.predict_noise`,
`run_unet`): each rank runs its rows of the UNet, one all-gather of the
noise prediction follows, and the guidance and the solver step run on
every rank.
"""

from __future__ import annotations

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
    replicate_module,
    shard_module,
)

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel


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


def _rows_coupled() -> tuple[type[fl.Module], ...]:
    """Layers that read other rows of the CFG batch than their own: StyleAligned
    takes each half's first sample as the reference, reference-only control
    mixes the first (unconditional) sample with the guide."""
    from refiners_tpu_torch.foundationals.latent_diffusion.reference_only_control import (
        SelfAttentionInjectionAdapter,
    )
    from refiners_tpu_torch.foundationals.latent_diffusion.style_aligned import ExtractReferenceFeatures

    return (ExtractReferenceFeatures, SelfAttentionInjectionAdapter)


def _check(unet: fl.Chain, split_rows: bool) -> None:
    """Raise where the UNet holds what the mesh would compute wrongly: under a
    row split, a layer that reads other rows; a split attention (output
    projection row-parallel) that an adapter entered after `shard_module`
    (SAG's map, StyleAligned: they would see this rank's heads only)."""
    coupled = _rows_coupled() if split_rows else ()
    for module in unet.modules():
        if coupled and isinstance(module, coupled):
            raise ValueError(
                f"{type(module).__name__} reads other rows of the CFG batch than its own: "
                "run it on a mesh with data = 1, or split the batch where it does not reach this layer"
            )
        if isinstance(module, fl.Attention) and not bare_attention(module):
            if isinstance(list(module)[-1], RowParallelLinear):
                raise ValueError(
                    f"an adapter entered a tensor-split {type(module).__name__} after the split: "
                    "inject it before the model is placed on the mesh (then the attention stays whole)"
                )


def _context_dicts(unet: fl.Chain) -> list[tuple[str, dict[str, Any]]]:
    """Every distinct context dict that the chains under `unet` read, by
    context name. `Chain.set_context` replaces the dict at the chain it is
    called on and updates the other chains' own copies in place, so a
    chain's copy can hold keys that the UNet's lacks (SDXL's "diffusion"
    context: the UNet's holds only the key set last)."""
    seen: dict[int, tuple[str, dict[str, Any]]] = {}
    stack: list[torch.nn.Module] = [unet]
    while stack:
        module = stack.pop()
        if isinstance(module, fl.Chain):
            for name, values in module.provider.contexts.items():
                seen.setdefault(id(values), (name, values))
        stack.extend(module._modules.values())
    return list(seen.values())


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
    map) is gathered, as the prediction is. A batch that does not divide
    runs whole on every rank. With `check`, raises where the UNet holds
    layers that a split would compute wrongly (`_check`: a walk of the
    whole tree, a few ms of host time, so a denoising loop checks at its
    first step)."""
    sharding = data_sharding(mesh, latents.ndim)
    split_rows = sharding.size > 1 and sharding.divides(latents)
    tensor = mesh.size(mesh.mesh_dim_names.index("tensor"))
    if check and (split_rows or tensor > 1):
        _check(unet, split_rows)
    if not split_rows:
        return unet(latents)
    batch = latents.shape[0]
    contexts = _context_dicts(unet)
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
    rows = batch // sharding.size
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
