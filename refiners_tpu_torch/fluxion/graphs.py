"""Compiled programs on CUDA graphs: the port's counterpart of ``jax.jit``.

A `Program` wraps a function of modules, tensors and plain values. On the
card each call looks up a program by a key that follows JAX's retrace rule
(``refiners_tpu/fluxion/layers/module.py``: the treedef is the module
structure plus every non-array attribute; arrays are arguments):

- in the key: each module tree's structure and types, every attribute
  that is not a tensor (LoRA scales, adapter settings, the solver's step
  count, hooks), the contexts' non-tensor values, the shape, dtype and
  device of every tensor, the plain arguments by value, the grad and
  inference modes, the TF32 and cuDNN settings, and the storage of every
  parameter and buffer (and of its ``.grad``): a replay reads the
  addresses of its capture, since the kernels' TMA maps are encoded on the
  host at each launch;
- not in the key: the tensors a call brings (tensor arguments, and the
  tensors in contexts and in plain attributes of the modules: a ControlNet
  condition, T2I features, image tokens). They are copied into static
  buffers that the program owns: a replay never reads a caller's tensor by
  address and never writes into one.

The first call under a key runs the function eagerly on a side stream
(cuBLAS, cuDNN and cuFFT set up outside the capture; its result is the
call's, its kernel launches counted as such), then captures it into a CUDA
graph with the static buffers in place of the call's tensors. Later calls
under the key copy their tensors into the static buffers, replay, and
return clones of the outputs. The contexts are put back as they were
before each run, as a jitted JAX function leaves its model's unchanged. A
capture that fails raises and names the operation, and so does a call
that changes its own key (it could never be replayed); nothing falls back
to the eager path. A program's graphs share one memory pool (`Pool`), and
programs that never run at the same time may share one too (a pipeline's
loop and decode): a replay's outputs are cloned before anything else
runs, and the static buffers live outside the pool, so that graphs never
overwrite what another one still needs.

Differences from ``jax.jit``: a parameter given new storage (an assignment,
``load_state_dict(assign=True)``) changes the key, where JAX does not
compile again; an in-place ``load_state_dict`` keeps it, as in JAX.

What runs eagerly: a function whose modules and tensors are not on a CUDA
device (the CPU, as the kernels run their plain versions there; the
contexts are put back as on the card), and a program given a mesh on gloo,
whose collectives run on the host (`eager_on`): it calls its function as
written. A mesh on NCCL is captured. `Program.eager` runs the function as
a first call runs it, on any device, for comparisons.

The kernels' launch counters are Python-side: the change of each during
the capture is recorded and added at every replay, so a counter reads the
same after a replay as after the eager call. Random draws inside a program
come from the device's default generator or from a CUDA `torch.Generator`
passed as an argument, which is registered with the graph: seeding it
again before a call (``manual_seed``) gives that call the eager draws of
the seed.

Spans (`fluxion.tracing`, each with ``program=<name>``): a call's key walk
and lookup (``refiners.Program.key``); a first call
(``refiners.Program.first_call``: its eager run, ``.eager``, and the
capture through the key check, ``.capture``); a replay's copy-in,
launch and output clones (``.copy_in``, ``.replay``, ``.clone``). On the
CPU only the key's span shows.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable

import torch

from refiners_tpu_torch.fluxion.tracing import span

_PLAIN = frozenset({type(None), bool, int, float, complex, str, bytes, torch.dtype, torch.device, torch.memory_format})
# torch.nn.Module's own bookkeeping (hook dicts and the like): in the key only when not empty
_BOOKKEEPING = frozenset(torch.nn.Module().__dict__) - {"training", "_parameters", "_buffers", "_modules"}
# read apart (`_provider`: the contexts) or not at all (`_parent` points up the tree)
_SKIPPED = frozenset({"_parameters", "_buffers", "_modules", "_provider", "_parent"})


def _counters() -> list[Any]:
    """Every kernel wrapper with a ``launches`` counter."""
    from refiners_tpu_torch.ops import flash_attention as fa
    from refiners_tpu_torch.ops import group_norm as gn
    from refiners_tpu_torch.ops import lora, quant

    return [
        fa.flash_attention_packed,
        fa.flash_attention,
        fa.flash_attention_relpos,
        fa.flash_attention_bwd_dkv,
        fa.flash_attention_bwd_dq,
        gn.group_norm_stats,
        gn.group_norm_apply,
        quant.quantize_int8,
        quant.quantize_rows_int8,
        lora.lora_add_,
    ]


def eager_on(mesh: Any) -> bool:
    """True for a mesh whose collectives cannot be captured (gloo runs them
    on the host); False for no mesh or a mesh on NCCL."""
    if mesh is None:
        return False
    import torch.distributed as dist

    return dist.get_backend(mesh.get_group(0)) != "nccl"


def _storage(t: torch.Tensor) -> int:
    local = getattr(t, "_local_tensor", t)  # a DTensor's shard
    return local.data_ptr()


class _Identity:
    """An unhashable attribute in the key: equal only to itself, and kept
    alive by the key (so that its id is not reused while the key lives)."""

    __slots__ = ("value",)

    def __init__(self, value: Any) -> None:
        self.value = value

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _Identity) and other.value is self.value

    def __hash__(self) -> int:
        return id(self.value)


class _Walk:
    """One pass over a call's arguments and the modules among them: the
    key's tokens, and where the call's own tensors sit."""

    def __init__(self, args: list[Any], kwargs: dict[str, Any]) -> None:
        backends = torch.backends
        self.tokens: list[Any] = [
            torch.is_grad_enabled(),
            torch.is_inference_mode_enabled(),
            # what the captured kernels were chosen under
            backends.cuda.matmul.allow_tf32,
            backends.cudnn.allow_tf32,
            backends.cudnn.deterministic,
            backends.cudnn.benchmark,
        ]
        self.modules: dict[int, int] = {}  # id → walk index
        self.contexts: dict[int, tuple[int, Any]] = {}  # id → (walk index, the context dict)
        self.providers: dict[int, dict[str, Any]] = {}
        self.tensors: list[torch.Tensor] = []  # the call's tensors, each once
        self.index: dict[int, int] = {}  # id(tensor) → position in `tensors`
        self.slots: list[tuple[Any, Any]] = []  # (container, key) holding tensors outside a context
        self.generators: list[torch.Generator] = []
        self.device: torch.device | None = None
        for i, value in enumerate(args):
            self._value(value, (args, i))
        for name, value in kwargs.items():
            self.tokens.append(name)
            self._value(value, (kwargs, name))

    @property
    def key(self) -> tuple[Any, ...]:
        return tuple(self.tokens)

    def _place(self, t: torch.Tensor) -> None:
        if self.device is None and t.device.type != "meta":
            self.device = t.device

    def _value(self, v: Any, slot: tuple[Any, Any] | None) -> bool:
        """Append the tokens of `v`; True if it holds a tensor of the call."""
        tokens, kind = self.tokens, type(v)
        if kind in _PLAIN or isinstance(v, Enum):
            tokens.append(v)
            return False
        if kind is torch.nn.Parameter:  # another module's weight, read by address as its own
            tokens.append(("P", tuple(v.shape), v.dtype, v.device, _storage(v), v.requires_grad))
            return False
        if isinstance(v, torch.Tensor):
            self._place(v)
            index = self.index.setdefault(id(v), len(self.tensors))
            if index == len(self.tensors):
                self.tensors.append(v)
            # the position says which of the call's tensors are one: aliasing is part of the program
            tokens.append(("T", tuple(v.shape), v.dtype, v.device, v.requires_grad, index))
            if slot is not None:
                self.slots.append(slot)
            return True
        if isinstance(v, torch.nn.Module):
            self._module(v)
            return False
        if kind in (set, frozenset) and all(type(x) in _PLAIN for x in v):
            tokens.append((kind, frozenset(v)))
            return False
        if kind in (list, tuple, dict) or isinstance(v, (list, tuple, dict)):
            if kind is not dict and all(type(x) in _PLAIN for x in v):
                tokens.append((kind, *v))
                return False
            items = v.items() if isinstance(v, dict) else enumerate(v)
            tokens.append((kind, len(v)))
            held = False
            for k, item in items:
                tokens.append(k)
                held = self._value(item, None) or held
            if held and slot is not None:
                self.slots.append(slot)
            return held
        if kind is torch.Generator and v.device.type == "cuda" and v not in self.generators:
            self.generators.append(v)
        try:
            hash(v)
            tokens.append(v)
        except TypeError:
            tokens.append(_Identity(v))
        return False

    def _module(self, m: torch.nn.Module) -> None:
        tokens = self.tokens
        if id(m) in self.modules:
            tokens.append(("ref", self.modules[id(m)]))
            return
        self.modules[id(m)] = len(self.modules)
        d = m.__dict__
        ignored = getattr(type(m), "_pytree_ignore", ())
        tokens.append(type(m))
        for name, p in d["_parameters"].items():
            if p is None:
                tokens.append((name, None))
                continue
            self._place(p)
            grad = None if p.grad is None else _storage(p.grad)
            tokens.append((name, tuple(p.shape), p.dtype, p.device, _storage(p), p.requires_grad, grad))
        for name, b in d["_buffers"].items():
            tokens.append((name, None) if b is None else (name, tuple(b.shape), b.dtype, b.device, _storage(b)))
        for name, v in d.items():
            if name in _SKIPPED or (name in _BOOKKEEPING and not v) or name in ignored:
                continue
            if type(v) in _PLAIN:
                tokens.append((name, v))
                continue
            tokens.append(name)
            self._value(v, (d, name))
        provider = d.get("_provider")
        if provider is not None:
            self._provider(provider.contexts)
        for name, child in d["_modules"].items():
            tokens.append(name)
            if child is None:
                tokens.append(None)
            else:
                self._module(child)

    def _provider(self, contexts: dict[str, Any]) -> None:
        self.providers.setdefault(id(contexts), contexts)
        tokens = self.tokens
        tokens.append("contexts")
        for name, context in contexts.items():
            seen = self.contexts.get(id(context))
            if seen is not None:
                tokens.append((name, seen[0]))
                continue
            self.contexts[id(context)] = (len(self.contexts), context)
            tokens.append(name)
            for key, value in context.items():
                tokens.append(key)
                self._value(value, (context, key))

    def snapshot(self) -> Callable[[], None]:
        """What puts the contexts and the bound slots back as they are now.
        A run writes into the contexts' lists and dicts in place: their
        contents are saved too, each container once (two contexts that
        hold one list hold one list again)."""
        contexts = [c for _, c in self.contexts.values()]
        memo: dict[int, Any] = {id(c): c for c in contexts}  # the context dicts stay the same objects
        dicts = [(d, {k: _containers(v, memo) for k, v in d.items()}) for d in (*self.providers.values(), *contexts)]
        slots = [(container, key, container[key]) for container, key in self.slots]

        def restore() -> None:
            for d, saved in dicts:
                d.clear()
                d.update(saved)
            for container, key, value in slots:
                container[key] = value

        return restore

    def bind(self, statics: list[torch.Tensor]) -> None:
        """Put the static buffers in place of the call's tensors."""
        for container, key in self.slots:
            container[key] = _rebuild(container[key], lambda t: statics[self.index[id(t)]])


def _containers(v: Any, memo: dict[int, Any]) -> Any:
    """`v` with each list and dict in it copied (once, by identity; the
    contexts' dicts themselves are kept), anything else shared."""
    if type(v) not in (list, dict):
        return v
    if id(v) not in memo:
        memo[id(v)] = [_containers(x, memo) for x in v] if type(v) is list else {k: _containers(x, memo) for k, x in v.items()}
    return memo[id(v)]


def _rebuild(v: Any, tensor: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    if isinstance(v, torch.Tensor):
        return tensor(v)
    if isinstance(v, dict):
        return type(v)((k, _rebuild(x, tensor)) for k, x in v.items())
    if isinstance(v, (list, tuple)) and not isinstance(v, torch.Size):
        items = [_rebuild(x, tensor) for x in v]
        return type(v)(*items) if hasattr(v, "_fields") else type(v)(items)
    return v


class CaptureError(RuntimeError):
    """A program's capture failed (a host read or transfer inside it), or
    its call changed its own key."""


def _failed_at(error: BaseException) -> str:
    """The innermost frame of the first error in the chain: the operation
    that broke the capture."""
    first = error
    while first.__context__ is not None and first.__context__ is not first:
        first = first.__context__
    frames = traceback.extract_tb(first.__traceback__)
    ours = [f for f in frames if "/torch/" not in f.filename] or frames
    if not ours:
        return f"{type(first).__name__}: {first}"
    f = ours[-1]
    return f"{f.filename}:{f.lineno} in {f.name} ({(f.line or '').strip()}): {type(first).__name__}: {first}"


def _first_difference(before: tuple[Any, ...], after: tuple[Any, ...]) -> str:
    """Where two keys part: the first token that differs, after the
    nearest module type and name before it."""
    i = next((i for i, (a, b) in enumerate(zip(before, after)) if a != b), min(len(before), len(after)))
    if i == min(len(before), len(after)):
        return f"the key went from {len(before)} to {len(after)} tokens"
    module = next((t.__qualname__ for t in reversed(before[:i]) if isinstance(t, type)), None)
    name = next((t for t in reversed(before[:i]) if isinstance(t, str)), None)
    return f"token {i} (in {module}, after {name!r}): {before[i]!r} became {after[i]!r}"


@dataclass
class _Entry:
    graph: Any
    statics: list[torch.Tensor]
    outputs: Any
    launches: dict[int, int]
    pool: Any  # the handle of the pool it was captured into


_streams: dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _recover(device: torch.device, generators: list[torch.Generator], states: list[Any]) -> None:
    """Undo what a capture that failed in CUDA leaves behind: `capture_end`
    then raises before it ends the pool's recording and takes the
    generators out of capture. The next capture takes a new side stream
    (and its pool a new handle)."""
    for generator, state in zip(generators, states):
        generator.graphsafe_set_state(state)
    _streams[device] = torch.cuda.Stream(device)


class Pool:
    """The device memory that the graphs of programs which never run at the
    same time share, per device (a pipeline's loop and decode). A program
    given none has its own."""

    def __init__(self) -> None:
        self._handles: dict[torch.device, Any] = {}
        self._programs: list[Program] = []

    def handle(self, device: torch.device) -> Any:
        """The pool to capture into on `device`; a new one where no graph
        holds the last (torch releases a pool with its last graph)."""
        current = self._handles.get(device)
        if current is None or not any(e.pool == current for program in self._programs for e in program._cache.values()):
            self._handles[device] = current = torch.cuda.graph_pool_handle()
        return current

    def drop(self, device: torch.device) -> None:
        self._handles.pop(device, None)

    def bytes(self) -> int:
        """The device memory the pool's graphs hold (its segments): what a
        replay uses beyond the tensors allocated outside it, which
        `torch.cuda.max_memory_allocated` does not see once the capture is
        over."""
        pools = {tuple(handle) for handle in self._handles.values()}
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s.get("segment_pool_id", ())) in pools)


class Program:
    """`fn` captured per key and replayed (module docstring). Calling the
    program calls `fn` with the same arguments; given a `mesh` on gloo it
    calls `fn` as written. Programs given one `pool` share its memory."""

    total_captures = 0  # graphs captured by every program so far

    def __init__(self, fn: Callable[..., Any], name: str | None = None, *, mesh: Any = None,
                 pool: Pool | None = None) -> None:  # fmt: skip
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self.runs_eagerly = eager_on(mesh)
        self.pool = pool if pool is not None else Pool()
        self.pool._programs.append(self)
        self._cache: dict[tuple[Any, ...], _Entry] = {}
        self.captures = 0  # graphs captured so far

    def key(self, *args: Any, **kwargs: Any) -> tuple[Any, ...]:
        """The key a call with these arguments looks up (on any device)."""
        return _Walk(list(args), dict(kwargs)).key

    def clear_cache(self) -> None:
        self._cache.clear()

    def pool_bytes(self) -> int:
        """The device memory of the program's pool (`Pool.bytes`)."""
        return self.pool.bytes()

    def eager(self, *args: Any, **kwargs: Any) -> Any:
        """`fn` run as the first call of a key runs it, on the current
        stream, on any device: eagerly, the contexts put back after."""
        a, kw = list(args), dict(kwargs)
        return self._run(a, kw, _Walk(a, kw), None)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if self.runs_eagerly:
            return self.fn(*args, **kwargs)
        a, kw = list(args), dict(kwargs)
        with span("refiners.Program.key", program=self.name):
            walk = _Walk(a, kw)
            device = walk.device
            on_card = device is not None and device.type == "cuda"
            entry = self._cache.get(walk.key) if on_card else None
            tensors = walk.tensors
            if entry is not None:  # a replay reads the call's tensors alone; freeing the walk is the key's cost too
                del walk
        if not on_card:
            return self._run(a, kw, walk, None)
        if entry is None:
            with span("refiners.Program.first_call", program=self.name):
                return self._first_call(a, kw, walk, device)
        return self._replay(entry, tensors)

    def _run(self, a: list[Any], kw: dict[str, Any], walk: _Walk, statics: list[torch.Tensor] | None) -> Any:
        restore = walk.snapshot()
        try:
            if statics is not None:
                walk.bind(statics)
            return self.fn(*a, **kw)
        finally:
            restore()

    def _first_call(self, a: list[Any], kw: dict[str, Any], walk: _Walk, device: torch.device) -> Any:
        stream, current = _side_stream(device), torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with span("refiners.Program.eager", program=self.name), torch.cuda.stream(stream):
            result = self._run(a, kw, walk, None)
        current.wait_stream(stream)

        walk = _Walk(a, kw)  # the state the capture reads (a first run may set attributes)
        statics = [torch.empty_like(t) for t in walk.tensors]
        graph = torch.cuda.CUDAGraph()
        default = torch.cuda.default_generators[device.index if device.index is not None else torch.cuda.current_device()]
        generators = [default, *(g for g in walk.generators if g is not default)]
        for generator in generators[1:]:
            graph.register_generator_state(generator)
        states = [g.clone_state() for g in generators]  # a failed capture leaves its generators capturing
        pool = self.pool.handle(device)
        counters = _counters()
        before = [c.launches for c in counters]
        with span("refiners.Program.capture", program=self.name):
            try:
                # `torch.cuda.graph` without its synchronize and `empty_cache` (which would free every cached
                # block, for the eager work that follows to allocate again)
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        outputs = self._run(a, kw, walk, statics)
                    finally:
                        graph.capture_end()
            except Exception as error:
                _recover(device, generators, states)
                self.pool.drop(device)
                raise CaptureError(f"{self.name}: the CUDA graph capture failed at {_failed_at(error)}") from error
            finally:
                launched = {i: c.launches - n for i, (c, n) in enumerate(zip(counters, before)) if c.launches != n}
                for c, n in zip(counters, before):
                    c.launches = n  # nothing ran during the capture
            torch.cuda.current_stream(device).wait_stream(stream)
            self._check_key(walk.key, _Walk(a, kw).key)
        self._cache[walk.key] = _Entry(graph, statics, outputs, launched, pool)
        self.captures += 1
        Program.total_captures += 1
        return result

    def _check_key(self, before: tuple[Any, ...], after: tuple[Any, ...]) -> None:
        """Raise if a call changed its own key: no later call could replay its graph."""
        if after != before:
            raise CaptureError(f"{self.name}: a call changes its own key, so that no later call could replay "
                               f"its graph: {_first_difference(before, after)}")  # fmt: skip

    def _replay(self, entry: _Entry, tensors: list[torch.Tensor]) -> Any:
        with span("refiners.Program.copy_in", program=self.name):
            if entry.statics:
                torch._foreach_copy_(entry.statics, tensors)
        with span("refiners.Program.replay", program=self.name):
            entry.graph.replay()
            counters = _counters()
            for i, n in entry.launches.items():
                counters[i].launches += n
        with span("refiners.Program.clone", program=self.name):
            return _rebuild(entry.outputs, lambda t: t.clone())
