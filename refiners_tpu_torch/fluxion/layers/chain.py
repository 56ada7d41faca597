"""Chain: the core declarative composition layer, plus its combinators.

Counterpart of ``refiners_tpu/fluxion/layers/chain.py`` (Chain :54,
combinators :388-527). Ordered uniquely-named children, a sequential forward
that threads tuple outputs, context plumbing, tree ops (walk / insert /
replace / structural_copy) and located errors. Children live in torch's
``_modules`` under their unique names, so ``state_dict()`` keys are the JAX
package's key paths.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterable, Iterator, Sequence, TypeVar, cast

import torch

from refiners_tpu_torch.fluxion.context import ContextProvider, Contexts
from refiners_tpu_torch.fluxion.layers.module import ContextModule, Module, ModuleTree

T = TypeVar("T", bound=Module)
TChain = TypeVar("TChain", bound="Chain")


def generate_unique_names(modules: tuple[Module, ...]) -> dict[str, Module]:
    """Name children ``ClassName`` or ``ClassName_N`` when duplicated."""
    class_counts: dict[str, int] = {}
    for module in modules:
        cn = module.__class__.__name__
        class_counts[cn] = class_counts.get(cn, 0) + 1
    counter: dict[str, int] = {}
    named: dict[str, Module] = {}
    for module in modules:
        cn = module.__class__.__name__
        counter[cn] = counter.get(cn, 0) + 1
        name = f"{cn}_{counter[cn]}" if class_counts[cn] > 1 else cn
        named[name] = module
    return named


def structural_copy(m: T) -> T:
    return m.structural_copy() if isinstance(m, ContextModule) else m


class ChainError(RuntimeError):
    """Raised when an error occurs during the execution of a Chain."""

    def __init__(self, message: str, /) -> None:
        super().__init__(message)


class Chain(ContextModule):
    """Sequential composition with named children and graph-editing API."""

    _modules: dict[str, Module]  # type: ignore[assignment]
    _provider: ContextProvider

    def __init__(self, *args: Module | Iterable[Module]) -> None:
        super().__init__()
        modules = self._flatten_args(args)
        for module in modules:
            # a ContextModule must never end up in two chains at once; adapters
            # freeze the parent pointer (`no_parent_refresh`) during wrapping
            assert (
                not isinstance(module, ContextModule)
                or not module._can_refresh_parent
                or module.parent is None
                or module.parent is self
            ), f"{module.__class__.__name__} already has parent {type(module.parent).__name__}"
        self._provider = ContextProvider()
        self._regenerate_keys(modules)
        self._reset_context()
        for module in self:
            if isinstance(module, ContextModule) and module.parent is not self:
                module._set_parent(self)

    @staticmethod
    def _flatten_args(args: tuple[Any, ...]) -> tuple[Module, ...]:
        out: list[Module] = []
        for a in args:
            if isinstance(a, Module):
                out.append(a)
            elif a is not None:
                out.extend(a)
        return tuple(out)

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, torch.nn.Module):
            raise ValueError(
                "Chain does not support setting modules by attribute; use a mutation method like `append`."
            )
        super().__setattr__(name, value)

    # -- context ------------------------------------------------------------

    @property
    def provider(self) -> ContextProvider:
        return self._provider

    def init_context(self) -> Contexts:
        """Default contexts; subclasses override."""
        return {}

    def _register_provider(self, context: Contexts | None = None) -> None:
        if context:
            self._provider.update_contexts(context)
        for module in self:
            if isinstance(module, Chain):
                module._register_provider(context=self._provider.contexts)

    def _reset_context(self) -> None:
        self._register_provider(self.init_context())

    def set_context(self, context: str, value: Any) -> None:
        self._provider.set_context(context, value)
        self._register_provider()

    def _set_parent(self, parent: "Chain | None") -> None:
        super()._set_parent(parent)
        if parent is None:
            # detached subtree keeps a snapshot of its contexts
            self._provider = ContextProvider.create(dict(self._provider.contexts))

    # -- forward ------------------------------------------------------------

    def forward(self, *args: Any) -> Any:
        result: Any = None
        intermediate: tuple[Any, ...] = args
        for name, layer in self._modules.items():
            result = self._call_layer(layer, name, *intermediate)
            intermediate = result if isinstance(result, tuple) else (result,)
        self._reset_context()
        return result

    def _call_layer(self, layer: Module, name: str, /, *args: Any) -> Any:
        try:
            return layer(*args)
        except (ChainError, ReturnException):
            raise
        except Exception as e:
            message = (
                f"{type(e).__name__} raised in {self.get_path()}.{name}: {e}\n\n"
                f"{self._show_error_in_tree(name)}"
            )
            raise ChainError(message) from e

    def _show_error_in_tree(self, name: str, /, max_lines: int = 20) -> str:
        tree = ModuleTree(module=self).generate(depth=2).splitlines()
        marked: list[str] = []
        for line in tree:
            if re.search(rf"(├── |└── ){re.escape(name)}\b", line) or (len(marked) == 0 and name in line):
                line = f"{line}  <--- ERROR HERE"
            marked.append(line)
        if len(marked) > max_lines:
            keep = next((i for i, l in enumerate(marked) if "ERROR HERE" in l), 0)
            lo = max(0, keep - max_lines // 2)
            marked = marked[lo : lo + max_lines]
        return "\n".join(marked)

    # -- container protocol -------------------------------------------------

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self) -> Iterator[Module]:
        return iter(self._modules.values())

    def __getitem__(self, key: int | str | slice) -> Any:
        if isinstance(key, slice):
            copy = self.structural_copy()
            copy._regenerate_keys(list(copy._modules.values())[key])
            for m in copy:
                if isinstance(m, ContextModule):
                    m._set_parent(copy)
            return copy
        if isinstance(key, str):
            return self._modules[key]
        return list(self._modules.values())[key]

    def __contains__(self, item: Module) -> bool:
        return any(m is item for m in self)

    def keys(self) -> Iterator[str]:
        return iter(self._modules.keys())

    def values(self) -> Iterator[Module]:
        return iter(self._modules.values())

    def items(self) -> Iterator[tuple[str, Module]]:
        return iter(self._modules.items())

    # -- tree traversal -----------------------------------------------------

    def walk(
        self, predicate: type[T] | Callable[[Module, "Chain"], bool] | None = None, recurse: bool = False
    ) -> Iterator[tuple[Any, "Chain"]]:
        """Walk the chain's tree, yielding (module, parent) matches."""
        if isinstance(predicate, type):
            mtype = predicate
            return self._walk(lambda m, _: isinstance(m, mtype), recurse)
        if predicate is None:
            return self._walk(lambda _m, _p: True, recurse)
        return self._walk(predicate, recurse)

    def _walk(self, predicate: Callable[[Module, "Chain"], bool], recurse: bool) -> Iterator[tuple[Module, "Chain"]]:
        for module in self:
            keep_going = True
            try:
                p = predicate(module, self)
            except StopIteration:
                p = False
                keep_going = False
            if p:
                yield module, self
                if not recurse:
                    continue
            if keep_going and isinstance(module, Chain):
                yield from module._walk(predicate, recurse)

    def layer(self, key: str | int | Sequence[str | int], layer_type: type[T] = Module) -> T:  # type: ignore[assignment]
        """Access a deep layer by path of keys/indices."""
        if isinstance(key, (str, int)):
            key = [key]
        current: Module = self
        for k in key:
            assert isinstance(current, Chain), f"not a Chain at {k}"
            current = current[k] if isinstance(k, int) else current._modules[k]
        if not isinstance(current, layer_type):
            raise AssertionError(f"layer at {key} is {type(current).__name__}, not {layer_type.__name__}")
        return cast(T, current)

    def layers(self, layer_type: type[T], recurse: bool = False) -> Iterator[T]:
        for m, _ in self.walk(layer_type, recurse):
            yield cast(T, m)

    def find(self, layer_type: type[T]) -> T | None:
        return next(self.layers(layer_type), None)

    def ensure_find(self, layer_type: type[T]) -> T:
        r = self.find(layer_type)
        assert r is not None, f"could not find {layer_type.__name__} in {self.__class__.__name__}"
        return r

    def find_parent(self, module: Module) -> "Chain | None":
        if any(m is module for m in self):
            return self
        for _, parent in self.walk(lambda m, _: m is module, recurse=False):
            return parent
        return None

    def ensure_find_parent(self, module: Module) -> "Chain":
        r = self.find_parent(module)
        assert r is not None, f"could not find {module} in {self}"
        return r

    # -- mutation -----------------------------------------------------------

    def _regenerate_keys(self, modules: Iterable[Module]) -> None:
        self._modules = generate_unique_names(tuple(modules))

    def insert(self, index: int, module: Module) -> None:
        if index < 0:
            index = max(0, len(self._modules) + index + 1)
        modules = list(self)
        modules.insert(index, module)
        self._regenerate_keys(modules)
        if isinstance(module, ContextModule):
            module._set_parent(self)
        self._register_provider()

    def insert_before_type(self, module_type: type[Module], new_module: Module) -> None:
        for i, module in enumerate(self):
            if isinstance(module, module_type):
                self.insert(i, new_module)
                return
        raise ValueError(f"No module of type {module_type.__name__} found in the chain.")

    def insert_after_type(self, module_type: type[Module], new_module: Module) -> None:
        for i, module in enumerate(self):
            if isinstance(module, module_type):
                self.insert(i + 1, new_module)
                return
        raise ValueError(f"No module of type {module_type.__name__} found in the chain.")

    def append(self, module: Module) -> None:
        self.insert(-1, module)

    def pop(self, index: int = -1) -> Module:
        """Remove and return the child at `index`."""
        modules = list(self)
        if index < 0:
            index = len(modules) + index
        if index < 0 or index >= len(modules):
            raise IndexError("Index out of range.")
        removed = modules.pop(index)
        if isinstance(removed, ContextModule):
            removed._set_parent(None)
        self._regenerate_keys(modules)
        return removed

    def remove(self, module: Module) -> None:
        modules = [m for m in self if m is not module]
        if len(modules) == len(self):
            raise ValueError(f"{module} is not in {self}")
        self._regenerate_keys(modules)
        if isinstance(module, ContextModule):
            module._set_parent(None)

    def replace(self, old_module: Module, new_module: Module, old_module_parent: "Chain | None" = None) -> None:
        """Replace a child in place — the `inject` primitive."""
        modules = list(self)
        try:
            i = next(i for i, m in enumerate(modules) if m is old_module)
        except StopIteration:
            raise ValueError(f"{old_module} is not in {self}")
        modules[i] = new_module
        self._regenerate_keys(modules)
        if isinstance(new_module, ContextModule):
            new_module._set_parent(self)
        if isinstance(old_module, ContextModule):
            old_module._set_parent(old_module_parent)
        # cascade this chain's live contexts into the new subtree so that
        # freshly injected adapters see the root contexts
        self._register_provider()

    def structural_copy(self: TChain) -> TChain:
        """Copy the tree structure; weighted leaves are shared."""
        if hasattr(self, "_pre_structural_copy"):
            self._pre_structural_copy()
        modules = [structural_copy(m) for m in self]
        clone = super().structural_copy()
        # fresh provider with fresh inner dicts: the clone must NOT share
        # context dicts with the source, or its end-of-forward context reset
        # would clobber the source tree's live contexts
        clone._provider = ContextProvider.create(clone.init_context())
        clone._regenerate_keys(modules)
        for module in clone:
            if isinstance(module, ContextModule):
                module._can_refresh_parent = True
                module._set_parent(clone)
        clone._reset_context()
        if hasattr(clone, "_post_structural_copy"):
            clone._post_structural_copy(self)
        return clone

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({', '.join(self._modules.keys())})"


class UseContext(ContextModule):
    """Read ``contexts[context][key]``, optionally post-processed."""

    def __init__(self, context: str, key: str) -> None:
        super().__init__()
        self.context = context
        self.key = key
        self.func: Callable[[Any], Any] = lambda x: x

    def forward(self, *args: Any) -> Any:
        context = self.use_context(self.context)
        assert self.key in context, f"key {self.key} not found in context {self.context}"
        return self.func(context[self.key])

    def compose(self, func: Callable[[Any], Any]) -> "UseContext":
        self.func = func
        return self


class SetContext(ContextModule):
    """Write the input into ``contexts[context][key]``, or hand it to
    ``callback(current_value, x)`` (used e.g. to append residuals)."""

    def __init__(self, context: str, key: str, callback: Callable[[Any, Any], Any] | None = None) -> None:
        super().__init__()
        self.context = context
        self.key = key
        self.callback = callback

    def forward(self, *args: Any) -> Any:
        x = args[0] if len(args) == 1 else args
        context = self.use_context(self.context)
        if self.callback is not None:
            self.callback(context[self.key], x)
        else:
            context[self.key] = x
        return x


class Lambda(Module):
    """Wrap an arbitrary callable as a layer."""

    def __init__(self, func: Callable[..., Any]) -> None:
        super().__init__()
        self.func = func

    def forward(self, *args: Any) -> Any:
        return self.func(*args)

    def __repr__(self) -> str:
        return f"Lambda({getattr(self.func, '__name__', 'lambda')})"


class Parallel(Chain):
    """Feed the same inputs to all children; return the tuple of outputs."""

    def forward(self, *args: Any) -> tuple[Any, ...]:
        outputs = tuple(self._call_layer(m, n, *args) for n, m in self._modules.items())
        self._reset_context()
        return outputs


class Distribute(Chain):
    """The i-th positional argument goes to the i-th child."""

    def forward(self, *args: Any) -> tuple[Any, ...]:
        n_args, n_mods = len(args), len(self._modules)
        assert n_args == n_mods, f"Number of positional arguments ({n_args}) must match number of sub-modules ({n_mods})."
        outputs = tuple(self._call_layer(m, n, arg) for arg, (n, m) in zip(args, self._modules.items()))
        self._reset_context()
        return outputs


class Passthrough(Chain):
    """Run children for their context side effects; return the inputs."""

    def forward(self, *args: Any) -> Any:
        super().forward(*args)
        return args[0] if len(args) == 1 else args


class Sum(Chain):
    """Sum of all children's outputs on the same inputs."""

    def forward(self, *args: Any) -> Any:
        output: Any = None
        for name, layer in self._modules.items():
            layer_output = self._call_layer(layer, name, *args)
            if isinstance(layer_output, tuple):
                layer_output = sum(layer_output)
            output = layer_output if output is None else output + layer_output
        self._reset_context()
        return output


class Residual(Chain):
    """x + chain(x)."""

    def forward(self, *args: Any) -> Any:
        assert len(args) == 1, "Residual takes a single input"
        return args[0] + super().forward(*args)


class Concatenate(Chain):
    """Concatenate children's outputs along `dim`."""

    def __init__(self, *modules: Module, dim: int = 0) -> None:
        super().__init__(*modules)
        self.dim = dim

    def forward(self, *args: Any) -> Any:
        outputs = [self._call_layer(m, n, *args) for n, m in self._modules.items()]
        self._reset_context()
        return torch.cat([o for o in outputs if o is not None], dim=self.dim)


class Matmul(Chain):
    """matmul(input(x), other(x)), in the promoted dtype of the two, as jnp.matmul."""

    def __init__(self, input: Module, other: Module) -> None:
        super().__init__(input, other)

    def forward(self, *args: Any) -> Any:
        a = self[0](*args)
        b = self[1](*args)
        self._reset_context()
        dtype = torch.promote_types(a.dtype, b.dtype)
        return torch.matmul(a.to(dtype), b.to(dtype))


class ReturnException(Exception):
    """Carries the value of a `Return` out of the chains that enclose it."""

    def __init__(self, value: Any):
        self.value = value


class Return(Module):
    """Raise ReturnException carrying the input."""

    def forward(self, *args: Any) -> Any:
        raise ReturnException(args[0] if len(args) == 1 else args)


class Breakpoint(ContextModule):
    """Drop into the debugger at this point in the chain (``vscode=True``:
    debugpy's breakpoint instead of pdb's)."""

    def __init__(self, vscode: bool = False):
        super().__init__()
        self.vscode = vscode

    def forward(self, *args: Any) -> Any:
        if self.vscode:
            import debugpy  # type: ignore

            debugpy.breakpoint()
        else:
            breakpoint()
        return args[0] if len(args) == 1 else args
