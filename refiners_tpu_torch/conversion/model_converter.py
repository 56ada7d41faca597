"""ModelConverter: autotracing weight conversion, torch model → port model;
counterpart of ``refiners_tpu/conversion/model_converter.py``.

Runs the torch source and the port's target side by side, hooks every basic
layer of each with `register_forward_hook`, aligns them by execution order
and parameter signature, then emits the target's state dict. Both sides
hold torch layouts, so the weights are copied as they are and the outputs
(NCHW on both sides) compare directly.
"""

from __future__ import annotations

from collections import defaultdict
from enum import Enum, auto
from pathlib import Path
from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl

ModuleArgs = tuple[Any, ...] | dict[str, Any]


class ConversionStage(Enum):
    """Lifecycle of a conversion."""

    INIT = auto()
    BASIC_LAYERS_MATCH = auto()
    SHAPE_AND_LAYERS_MATCH = auto()
    MODELS_OUTPUT_AGREE = auto()


_TARGET_BASIC_LAYERS = (
    fl.Linear,
    fl.Conv2d,
    fl.ConvTranspose2d,
    fl.LayerNorm,
    fl.GroupNorm,
    fl.LayerNorm2d,
    fl.Embedding,
)

_SOURCE_BASIC_LAYERS = (
    torch.nn.Linear,
    torch.nn.Conv2d,
    torch.nn.ConvTranspose2d,
    torch.nn.LayerNorm,
    torch.nn.GroupNorm,
    torch.nn.Embedding,
)


def _param_signature(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _signature_matches(source_module: torch.nn.Module, target_module: torch.nn.Module) -> bool:
    """The same parameter names with the same shapes (one layout on both sides)."""
    return _param_signature(source_module) == _param_signature(target_module)


def _trace(model: torch.nn.Module, layer_types: tuple[type, ...], args: ModuleArgs) -> list[tuple[str, torch.nn.Module]]:
    """The (path, module) of each basic layer of `model`, in the order of its
    first call during `model(*args)`."""
    order: list[tuple[str, torch.nn.Module]] = []
    seen: set[int] = set()
    handles = []

    def record(path: str) -> Any:
        def hook(module: torch.nn.Module, *_: Any) -> None:
            if id(module) not in seen:
                seen.add(id(module))
                order.append((path, module))

        return hook

    for path, module in model.named_modules():
        if isinstance(module, layer_types):
            handles.append(module.register_forward_hook(record(path)))
    try:
        with torch.no_grad():
            ModelConverter._call(model, args)
    finally:
        for handle in handles:
            handle.remove()
    return order


class ModelConverter:
    """Align a torch source and a port target by execution order.

    Example:
        converter = ModelConverter(source_model=torch_model, target_model=port_model)
        assert converter.run(source_args=(x,))
    """

    stage: ConversionStage = ConversionStage.INIT

    def __init__(
        self,
        source_model: torch.nn.Module,
        target_model: torch.nn.Module,
        threshold: float = 1e-5,
        skip_output_check: bool = False,
        verbose: bool = True,
    ) -> None:
        self.source_model = source_model
        self.target_model = target_model
        self.threshold = threshold
        self.skip_output_check = skip_output_check
        self.verbose = verbose
        self._mapping: dict[str, str] | None = None

    def __repr__(self) -> str:
        return (
            f"ModelConverter(source_model={self.source_model.__class__.__name__}, "
            f"target_model={self.target_model.__class__.__name__}, stage={self.stage.name})"
        )

    def __bool__(self) -> bool:
        return self.stage == ConversionStage.MODELS_OUTPUT_AGREE or (
            self.skip_output_check and self.stage == ConversionStage.SHAPE_AND_LAYERS_MATCH
        )

    def _log(self, message: str) -> None:
        if self.verbose:
            print(message)

    @staticmethod
    def _call(model: torch.nn.Module, args: ModuleArgs) -> Any:
        if isinstance(args, dict):
            return model(**args)
        return model(*args)

    # -- mapping -------------------------------------------------------------

    def map_state_dicts(self, source_args: ModuleArgs, target_args: ModuleArgs | None = None) -> dict[str, str] | None:
        """Target path → source path of each basic layer, by execution order."""
        target_args = target_args if target_args is not None else source_args
        source_order = _trace(self.source_model, _SOURCE_BASIC_LAYERS, source_args)
        target_order = _trace(self.target_model, _TARGET_BASIC_LAYERS, target_args)

        if len(source_order) != len(target_order):
            self._log(f"layer count mismatch: source {len(source_order)} != target {len(target_order)}")
            by_type_src: dict[str, int] = defaultdict(int)
            for _, m in source_order:
                by_type_src[type(m).__name__] += 1
            by_type_tgt: dict[str, int] = defaultdict(int)
            for _, m in target_order:
                by_type_tgt[type(m).__name__] += 1
            self._log(f"source: {dict(by_type_src)}\ntarget: {dict(by_type_tgt)}")
            return None
        self.stage = ConversionStage.BASIC_LAYERS_MATCH

        mapping: dict[str, str] = {}
        for (src_name, src_module), (tgt_path, tgt_module) in zip(source_order, target_order):
            if not _signature_matches(src_module, tgt_module):
                self._log(
                    f"signature mismatch at {tgt_path} ({type(tgt_module).__name__}) "
                    f"vs {src_name} ({type(src_module).__name__})"
                )
                return None
            mapping[tgt_path] = src_name
        self.stage = ConversionStage.SHAPE_AND_LAYERS_MATCH
        self._mapping = mapping
        return mapping

    def convert_state_dict(self, mapping: dict[str, str] | None = None) -> dict[str, torch.Tensor]:
        """The converted flat target state dict (copies of the source's tensors)."""
        mapping = mapping if mapping is not None else self._mapping
        assert mapping is not None, "call map_state_dicts first"
        source_state = self.source_model.state_dict()
        target_modules = dict(self.target_model.named_modules())
        out: dict[str, torch.Tensor] = {}
        for tgt_path, src_name in mapping.items():
            for param_key in target_modules[tgt_path].state_dict():
                if "." in param_key:
                    continue  # leaf params only; nested handled by their own mapping
                src_key = f"{src_name}.{param_key}" if src_name else param_key
                if src_key not in source_state:
                    continue
                out[f"{tgt_path}.{param_key}" if tgt_path else param_key] = source_state[src_key].detach().clone()
        return out

    def load(self) -> None:
        self.target_model.load_state_dict(self.convert_state_dict(), strict=False)

    # -- comparison ----------------------------------------------------------

    def compare_models(
        self, source_args: ModuleArgs, target_args: ModuleArgs | None = None, threshold: float | None = None
    ) -> bool:
        """Whether the two outputs agree within `threshold` (max abs, float32)."""
        threshold = threshold if threshold is not None else self.threshold
        target_args = target_args if target_args is not None else source_args
        with torch.no_grad():
            source_out = self._call(self.source_model, source_args).float()
            target_out = self._call(self.target_model, target_args).float()
        if source_out.shape != target_out.shape:
            self._log(f"output shape mismatch: {tuple(source_out.shape)} vs {tuple(target_out.shape)}")
            return False
        max_diff = float((source_out - target_out).abs().max())
        self._log(f"max output difference: {max_diff:.2e} (threshold {threshold:.2e})")
        if max_diff < threshold:
            self.stage = ConversionStage.MODELS_OUTPUT_AGREE
            return True
        return False

    def run(self, source_args: ModuleArgs, target_args: ModuleArgs | None = None) -> bool:
        """Full pipeline: trace → map → load → compare."""
        if self.map_state_dicts(source_args, target_args) is None:
            return False
        self.load()
        if self.skip_output_check:
            return True
        return self.compare_models(source_args, target_args)

    def save_to_safetensors(self, path: Path | str, metadata: dict[str, str] | None = None) -> None:
        from refiners_tpu_torch.fluxion.utils import save_to_safetensors

        save_to_safetensors(path, self.target_model.state_dict(), metadata=metadata)
