"""Rematerialization (activation checkpointing) for chain subtrees;
counterpart of ``refiners_tpu/parallel/remat.py``.

A `Recompute` chain runs its forward under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
subtree's activations are not kept for the backward but recomputed there,
trading its forward's operations (and kernel launches) once more for device
memory.

Contexts: torch recomputes during the backward, where a context read inside
the subtree would see the value present at backward time; JAX closes over
the value present at the forward. A `Recompute` keeps JAX's meaning: at its
forward it takes a copy of every context dict its subtree can read (lists
and dicts in them copied one level), and the recompute runs with those
values, the current ones put back after. So a context changed between the
forward and the backward does not change the gradient, and a list that the
subtree pops from or pushes to (the UNet's sampling shapes) is replayed
from its state at the forward. As in JAX, a subtree that writes a context
read outside it gives that value once, at the forward.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch
import torch.utils.checkpoint

import refiners_tpu_torch.fluxion.layers as fl


def _copy(context: dict[str, Any]) -> dict[str, Any]:
    return {key: value.copy() if isinstance(value, (list, dict)) else value for key, value in context.items()}


class Recompute(fl.Chain):
    """Chain whose forward runs under `torch.utils.checkpoint.checkpoint`
    (non-reentrant), with the contexts of its forward (see the module
    docstring). Without gradients it is a plain chain."""

    def _contexts(self) -> list[dict[str, Any]]:
        """The distinct context dicts that the modules under this chain read."""
        seen: dict[int, dict[str, Any]] = {}
        for chain in (self, *self.layers(fl.Chain, recurse=True)):
            for context in chain.provider.contexts.values():
                seen.setdefault(id(context), context)
        return list(seen.values())

    def forward(self, *args: Any) -> Any:
        if not torch.is_grad_enabled():
            return super().forward(*args)
        contexts = self._contexts()
        at_forward = [_copy(context) for context in contexts]

        @contextlib.contextmanager
        def forward_contexts() -> Iterator[None]:
            now = [dict(context) for context in contexts]
            for context, saved in zip(contexts, at_forward):
                context.clear()
                context.update(_copy(saved))
            try:
                yield
            finally:
                for context, current in zip(contexts, now):
                    context.clear()
                    context.update(current)

        # no early stop: it ends the recompute by raising through the chain, whose layers wrap every exception;
        # under a CUDA graph capture (a compiled training step) the generators' state cannot be read: there a
        # subtree that draws random numbers would recompute with other draws (no port layer draws in a forward)
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return torch.utils.checkpoint.checkpoint(
                super().forward,
                *args,
                use_reentrant=False,
                preserve_rng_state=not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()),
                context_fn=lambda: (contextlib.nullcontext(), forward_contexts()),
            )


def apply_remat(root: fl.Chain, types: type[fl.Module] | tuple[type[fl.Module], ...]) -> int:
    """Wrap every instance of `types` found under `root` in a `Recompute`.

    Returns the number of wrapped modules. The wrap is ordinary chain
    surgery, undone by `remove_remat`.
    """
    matches = [(module, parent) for module, parent in root.walk(recurse=True) if isinstance(module, types)]
    for module, parent in matches:
        with module.no_parent_refresh():
            wrapper = Recompute(module)
        parent.replace(module, wrapper)
        module._set_parent(wrapper)
    return len(matches)


def remove_remat(root: fl.Chain) -> int:
    """Undo `apply_remat`: unwrap every `Recompute` under `root`."""
    wrappers = [(module, parent) for module, parent in root.walk(Recompute, recurse=True)]
    for wrapper, parent in wrappers:
        inner = wrapper[0]
        with inner.no_parent_refresh():
            parent.replace(wrapper, inner)
        inner._set_parent(parent)
    return len(wrappers)
