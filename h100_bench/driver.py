"""What every traffic driver shares: the device, the spans the harness
takes around the program's calls (its own wrappers, put back by
`unwrap`), the profiled stretch and the programs' pools."""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from typing import Any, Callable

import torch

from h100_bench.bench import Cell


def _no_span(name: str) -> Any:
    return nullcontext()


class Driver:
    def __init__(self, cell: Cell, seed: int, device: torch.device) -> None:
        self.cell, self.seed, self.device = cell, seed, device
        self.programs: dict[int, Any] = {}  # every `Program` called, by id
        self.host_s = 0.0  # host seconds inside `Program.__call__`
        self.annotate: Callable[[str], Any] = _no_span  # `record_function` in the profiled stretch
        self._originals: list[tuple[Any, str, Any]] = []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _patch(self, owner: Any, name: str, make: Callable[[Any], Any]) -> None:
        original = getattr(owner, name)
        self._originals.append((owner, name, original))
        setattr(owner, name, make(original))

    def span(self, owner: Any, name: str, label: str) -> None:
        """Name `owner.name`'s calls `label` in the trace (patched on a class, not
        an instance: a program's key reads the model's own attributes)."""

        def make(fn: Callable[..., Any]) -> Callable[..., Any]:
            def inner(*args: Any, **kwargs: Any) -> Any:
                with self.annotate(label):
                    return fn(*args, **kwargs)

            return inner

        self._patch(owner, name, make)

    def time_programs(self, on_output: Callable[[Any, Any], None] | None = None) -> None:
        """Time every `Program.__call__` on the host, name it in the trace,
        and hand each program's output to `on_output`."""
        from refiners_tpu_torch.fluxion.graphs import Program

        def make(call: Callable[..., Any]) -> Callable[..., Any]:
            def timed(program: Any, *args: Any, **kwargs: Any) -> Any:
                self.programs[id(program)] = program
                with self.annotate(f"Program:{program.name}"):
                    start = time.perf_counter()
                    out = call(program, *args, **kwargs)
                    self.host_s += time.perf_counter() - start
                if on_output is not None:
                    on_output(program, out)
                return out

            return timed

        self._patch(Program, "__call__", make)

    def unwrap(self) -> None:
        while self._originals:
            owner, name, original = self._originals.pop()
            setattr(owner, name, original)

    def profiled(self, annotate: Callable[[str], Any], n: int, one: Callable[[], Any]) -> None:
        """`one()` `n` times inside the stretch's span, synchronised, the
        harness's spans recorded."""
        self.annotate = annotate
        try:
            with annotate("h100_bench.stretch"):
                for _ in range(n):
                    one()
                self.sync()
        finally:
            self.annotate = _no_span

    def pool_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        pools = {id(p.pool): p.pool for p in self.programs.values()}
        return sum(pool.bytes() for pool in pools.values())

    def release(self) -> None:
        """Put the wrappers back and return the freed memory to the card."""
        self.unwrap()
        self.programs.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
