"""Module base classes as ``torch.nn.Module``s.

Counterpart of ``refiners_tpu/fluxion/layers/module.py`` (Module :76,
ContextModule :315, WeightedModule :390). The JAX package registers every
module as a pytree node; here a module is a ``torch.nn.Module``, so weights
are ``nn.Parameter``s and sub-modules live in ``_modules``. Chains name their
children with ``generate_unique_names``, which makes ``state_dict()`` keys the
same dotted paths as the JAX package's ``state_dict()``.

Parent pointers are stored in a one-element list so that torch does not
register the parent as a child (which would make the tree cyclic).
"""

from __future__ import annotations

import contextlib
import copy
import inspect
from typing import TYPE_CHECKING, Any, Iterator, TypeVar

import torch

if TYPE_CHECKING:
    from refiners_tpu_torch.fluxion.context import ContextProvider
    from refiners_tpu_torch.fluxion.layers.chain import Chain

T = TypeVar("T", bound="Module")

BasicType = str | float | int | bool


class Module(torch.nn.Module):
    """Base class for all layers."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        torch.nn.Module.__init__(self)

    @property
    def dtype(self) -> torch.dtype | None:
        """dtype of the first floating-point parameter, if any."""
        for p in self.parameters():
            if p.is_floating_point():
                return p.dtype
        return None

    @property
    def device(self) -> torch.device | None:
        for p in self.parameters():
            return p.device
        return None

    # -- safetensors --------------------------------------------------------

    def load_from_safetensors(self: T, path: Any, strict: bool = True) -> T:
        """Load weights from a safetensors file in the port's (torch) layout;
        each tensor is copied into the parameter of its key, on that
        parameter's device and in its dtype."""
        from refiners_tpu_torch.fluxion.utils import load_from_safetensors

        self.load_state_dict(load_from_safetensors(path), strict=strict)
        return self

    # -- introspection ------------------------------------------------------

    def basic_attributes(self, init_attrs_only: bool = False) -> dict[str, Any]:
        """Basic (str/int/float/bool) attributes for repr."""
        sig = inspect.signature(self.__class__.__init__)
        init_params = set(sig.parameters.keys()) if init_attrs_only else None
        # attributes equal to their constructor default are omitted from repr
        defaults = {k: p.default for k, p in sig.parameters.items() if p.default is not inspect.Parameter.empty}

        def is_basic(v: Any) -> bool:
            if isinstance(v, BasicType):  # type: ignore[arg-type]
                return True
            return isinstance(v, (tuple, list)) and all(is_basic(x) for x in v)

        out: dict[str, Any] = {}
        for k, v in self.__dict__.items():
            if k.startswith("_") or k == "training" or not is_basic(v):
                continue
            if init_params is not None and (k not in init_params or v == defaults.get(k)):
                continue
            out[k] = v
        return out

    def __repr__(self) -> str:
        attrs = ", ".join(f"{k}={v}" for k, v in self.basic_attributes(init_attrs_only=True).items())
        return f"{self.__class__.__name__}({attrs})"

    def get_path(self, parent: "Chain | None" = None, top: "Module | None" = None) -> str:
        """Dotted path of this module in the tree."""
        p = parent if parent is not None else getattr(self, "parent", None)
        if p is None or self is top:
            return self.__class__.__name__
        for name, mod in p._modules.items():
            if mod is self:
                return f"{p.get_path(top=top)}.{name}"
        raise ValueError(f"{self} not found in {p}")


class ContextModule(Module):
    """Module with a parent pointer and access to the root ContextProvider."""

    _parent: "list[Chain]"
    _can_refresh_parent: bool

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._parent = []
        self._can_refresh_parent = True

    @property
    def parent(self) -> "Chain | None":
        return self._parent[0] if self._parent else None

    @property
    def ensure_parent(self) -> "Chain":
        assert self._parent, "module is not bound to a Chain"
        return self._parent[0]

    def _set_parent(self, parent: "Chain | None") -> None:
        if not self._can_refresh_parent:
            return
        if parent is None:
            self._parent = []
            return
        assert any(m is self for m in parent), "could not find module in parent"
        self._parent = [parent]

    @property
    def provider(self) -> "ContextProvider":
        return self.ensure_parent.provider

    def get_parents(self) -> "list[Chain]":
        return [self.parent, *self.parent.get_parents()] if self.parent else []

    @contextlib.contextmanager
    def no_parent_refresh(self) -> Iterator[None]:
        """Freeze the parent pointer: `setup_adapter` wraps a target in an
        adapter chain without stealing the target's parent."""
        self._can_refresh_parent = False
        try:
            yield
        finally:
            self._can_refresh_parent = True

    def use_context(self, context_name: str) -> dict[str, Any]:
        """Retrieve a context dict from the root provider."""
        context = self.provider.get_context(context_name)
        assert context is not None, f"Context {context_name} not found."
        return context

    def structural_copy(self: T) -> T:
        """Clone sharing parameters; Chains override to copy their structure.

        torch keeps parameters, buffers, children and hooks in dicts on the
        instance: the clone gets its own copies of those dicts (whose values,
        the parameters, stay shared)."""
        clone = object.__new__(self.__class__)
        clone.__dict__.update(
            {k: copy.copy(v) if k.startswith("_") and isinstance(v, (dict, set)) else v for k, v in self.__dict__.items()}
        )
        clone._parent = []
        clone._can_refresh_parent = True
        return clone


class WeightedModule(Module):
    """A leaf module with weights; its dtype and device are its weight's."""

    weight: torch.nn.Parameter

    @property
    def dtype(self) -> torch.dtype:
        return self.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.weight.device


class ModuleTree:
    """Pretty tree repr of a module hierarchy."""

    def __init__(self, module: Module) -> None:
        self.root = self._module_to_tree(module)

    def generate(self, depth: int = -1) -> str:
        lines: list[str] = []
        self._render(self.root, lines, prefix="", is_last=True, is_root=True, depth=depth)
        return "\n".join(lines)

    def _module_to_tree(self, module: torch.nn.Module) -> dict[str, Any]:
        from refiners_tpu_torch.fluxion.layers.chain import Chain

        children = []
        if isinstance(module, Chain):
            children = [self._module_to_tree(child) for child in module._modules.values()]
        return {"label": repr(module), "children": children}

    def _render(
        self, node: dict[str, Any], lines: list[str], prefix: str, is_last: bool, is_root: bool, depth: int
    ) -> None:
        if is_root:
            lines.append(f"({node['label']})")
        else:
            connector = "└── " if is_last else "├── "
            lines.append(f"{prefix}{connector}{node['label']}")
        if depth == 0:
            return
        children = node["children"]
        child_prefix = prefix if is_root else prefix + ("    " if is_last else "│   ")
        for i, child in enumerate(children):
            self._render(child, lines, child_prefix, i == len(children) - 1, False, depth - 1)
