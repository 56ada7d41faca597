"""Spans at the port's layer boundaries: where the host's time goes in a
request or a training step.

    from refiners_tpu_torch.fluxion import tracing

    tracing.enable()
    image = pipe("a cat", seed=1)
    tracing.totals()["refiners.Program.key"]  # {"count": 2, "total_s": ..., "self_s": ..., "by": {...}}

Off by default: `span` then returns one shared no-op context after one
flag check, with no allocation and no clock read. On (`enable`), each span
reads its start and end on ``time.perf_counter_ns``, takes its parent from
the thread's stack of open spans and the id of its request or step from
its root span (the root's ``id=``, else the next number of a count), and
adds its duration into `totals`: count, total seconds and self seconds
(the duration less what its child spans cover) per name, and per name and
attributes under ``"by"``. While a ``torch.profiler`` records, each span
also opens ``record_function(name)`` with its id and attributes as args:
kineto stamps it on the clock of the device trace, so that the Chrome
trace of `profiling.trace` shows it beside the kernels it launched.

Every name starts with ``refiners.``; one under ``refiners.wait.`` marks
the host blocked on the card, so that a layer's self time is host work.
No span sits inside a function that a `graphs.Program` captures: it would
run at the capture and never at a replay.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import Any

import torch

_NOOP = nullcontext()
_on = False
_clock = time.perf_counter_ns
_lock = threading.Lock()  # guards `_totals`
_local = threading.local()  # each thread's stack of open spans
_ids = itertools.count()
# name → [count, total ns, self ns, {attributes: [count, total ns, self ns]}]
_totals: dict[str, list[Any]] = {}


def span(name: str, **attrs: Any) -> Any:
    """A context that records the block as the span `name` when tracing is on."""
    if not _on:
        return _NOOP
    return Span(name, attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget the totals (spans open now still add theirs when they end)."""
    with _lock:
        _totals.clear()


def totals() -> dict[str, dict[str, Any]]:
    """Per span name: ``count``, ``total_s``, ``self_s`` and ``by``, the same
    per attribute string (``"program=TextToImage.diffuse"``)."""

    def seconds(entry: list[Any]) -> dict[str, Any]:
        return {"count": entry[0], "total_s": entry[1] / 1e9, "self_s": entry[2] / 1e9}

    with _lock:
        return {name: {**seconds(e), "by": {k: seconds(v) for k, v in e[3].items()}} for name, e in _totals.items()}


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span while tracing is on: `parent`, `id`, `start_ns`, `end_ns`."""

    __slots__ = ("name", "attrs", "parent", "id", "start_ns", "end_ns", "_children_ns", "_record")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.parent is not None:
            self.id = self.parent.id
        else:
            self.id = self.attrs["id"] if "id" in self.attrs else next(_ids)
        self._children_ns, self._record = 0, None
        if torch._C._autograd._profiler_enabled():
            args = " ".join(f"{k}={v}" for k, v in {"id": self.id, **self.attrs}.items())
            self._record = torch.profiler.record_function(self.name, args=args)
            self._record.__enter__()
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end_ns = _clock()
        _stack().pop()
        if self._record is not None:
            self._record.__exit__(*exc)
        duration = self.end_ns - self.start_ns
        if self.parent is not None:
            self.parent._children_ns += duration
        own = duration - self._children_ns
        by = " ".join(f"{k}={v}" for k, v in self.attrs.items() if k != "id")
        with _lock:
            entry = _totals.setdefault(self.name, [0, 0, 0, {}])
            entry[0] += 1
            entry[1] += duration
            entry[2] += own
            if by:
                part = entry[3].setdefault(by, [0, 0, 0])
                part[0] += 1
                part[1] += duration
                part[2] += own
