"""Context store for declarative graphs.

Counterpart of ``refiners_tpu/fluxion/context.py``: a two-level mapping
``contexts[name][key] -> value`` owned by the root of a module tree. Reads and
writes happen eagerly while a Chain runs; values are tensors on the model's
device or plain Python data.
"""

from __future__ import annotations

from typing import Any

Context = dict[str, Any]
Contexts = dict[str, Context]


class ContextProvider:
    """Owns the context store for a module tree."""

    def __init__(self) -> None:
        self.contexts: Contexts = {}

    def set_context(self, key: str, value: Context) -> None:
        self.contexts[key] = value

    def get_context(self, key: str) -> Any:
        return self.contexts.get(key)

    def update_contexts(self, new_contexts: Contexts) -> None:
        # A context dict absent here is adopted BY REFERENCE (shared with the
        # source provider) so later mutations propagate through the tree; a
        # present one is updated in place.
        for key, value in new_contexts.items():
            if key not in self.contexts:
                self.contexts[key] = value
            else:
                self.contexts[key].update(value)

    @staticmethod
    def create(contexts: Contexts) -> "ContextProvider":
        provider = ContextProvider()
        provider.update_contexts(contexts)
        return provider

    def __repr__(self) -> str:
        keys = ", ".join(self.contexts.keys())
        return f"{self.__class__.__name__}({keys})"
