"""Adapter protocol: structural model patching.

Counterpart of ``refiners_tpu/fluxion/adapters/adapter.py``. `inject()`
swaps the target for the adapter inside the target's parent chain;
`eject()` puts the target back.
"""

from __future__ import annotations

import contextlib
from typing import Any, Generic, Iterator, TypeVar

import refiners_tpu_torch.fluxion.layers as fl

T = TypeVar("T", bound=fl.Module)
TAdapter = TypeVar("TAdapter", bound="Adapter[Any]")


class Adapter(Generic[T]):
    """Mixin for adapters; concrete adapters must also subclass `fl.Chain`."""

    # a one-element list keeps torch from registering the target as a child
    _target: "list[T]"

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        assert issubclass(cls, fl.Chain), f"Adapter {cls.__name__} must be a Chain"

    @property
    def target(self) -> T:
        return self._target[0]

    @contextlib.contextmanager
    def setup_adapter(self, target: T) -> Iterator[None]:
        """Set the target; call the Chain constructor inside this context."""
        assert isinstance(self, fl.Chain)
        assert "_modules" not in self.__dict__ or len(self) == 0, (
            "Call the Chain constructor in the setup_adapter context."
        )
        self._target = [target]
        if isinstance(target, fl.ContextModule):
            with target.no_parent_refresh():
                yield
        else:
            yield

    def inject(self: TAdapter, parent: fl.Chain | None = None) -> TAdapter:
        """Replace the target by the adapter inside the target's parent."""
        assert isinstance(self, fl.Chain)

        if (parent is None) and isinstance(self.target, fl.ContextModule):
            parent = self.target.parent
            if parent is not None:
                assert isinstance(parent, fl.Chain), f"{self.target} has invalid parent {parent}"

        target_parent = self.find_parent(self.target)

        if parent is None:
            if isinstance(self.target, fl.ContextModule):
                self.target._set_parent(target_parent)
            return self

        # `true_parent` may differ from `parent` when stacking pre-built adapters
        true_parent = parent.ensure_find_parent(self.target)
        true_parent.replace(old_module=self.target, new_module=self, old_module_parent=target_parent)
        return self

    def eject(self) -> None:
        """Restore the target in place of the adapter."""
        assert isinstance(self, fl.Chain)
        # stacked adapters: restore the topmost adapter still wrapping our target
        actual_target = lookup_top_adapter(self, self.target)
        if (parent := self.parent) is None:
            if isinstance(actual_target, fl.ContextModule):
                actual_target._set_parent(None)
        else:
            parent.replace(old_module=self, new_module=actual_target)

    def _pre_structural_copy(self) -> None:
        if isinstance(self.target, fl.Chain):
            raise RuntimeError(f"Chain adapters ({self}) typically cannot be copied, eject them first.")

    def _post_structural_copy(self: TAdapter, source: TAdapter) -> None:
        self._target = [source.target]


def lookup_top_adapter(top: fl.Chain, target: fl.Module) -> fl.Module:
    """The last adapter wrapping `target` under `top` (or `target`)."""
    target_parent = top.find_parent(target)
    if (target_parent is None) or (target_parent is top):
        return target
    r, p = target, target_parent
    while p is not top:
        if isinstance(p, Adapter):
            r = p
        assert p.parent, f"parent tree of {top} is broken"
        p = p.parent
    return r
