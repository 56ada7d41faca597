"""The port's spans (`refiners_tpu_torch.fluxion.tracing`):

- off, `span` is one shared no-op that allocates nothing, reads no clock
  and records nothing;
- on, nesting, self time and request ids against a fake clock; reset,
  disable and threads;
- a tiny `TextToImage` call and tiny `Trainer` steps emit exactly the
  spans their docstrings name, under the right parents;
- under ``torch.profiler`` the spans are kineto user annotations, nested
  as recorded, around the operations launched inside them;
- every span of the port is named ``refiners.*`` and sits where the
  docstrings say, outside the functions that programs capture;
- on the card (``-m cuda``), a program's first calls counted by its span
  equal `Program.captures`, and its replays the replay span's count.

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

from __future__ import annotations

import ast
import threading
import tracemalloc
from pathlib import Path
from typing import Any, Iterator

import pytest
import torch

import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.training_utils as tu
from refiners_tpu_torch.fluxion import graphs, tracing
from refiners_tpu_torch.fluxion.tracing import span
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, SD1Autoencoder, SD1UNet, StableDiffusion_1
from refiners_tpu_torch.pipelines import TextToImage

PORT = Path(__file__).resolve().parents[1] / "refiners_tpu_torch"


@pytest.fixture(autouse=True)
def _tracer_off_after() -> Iterator[None]:
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def fake_clock(monkeypatch: pytest.MonkeyPatch) -> list[int]:
    """`tracing`'s clock reads 0, 10, 20, ... ns; returns the next reading."""
    now = [0]

    def clock() -> int:
        now[0] += 10
        return now[0] - 10

    monkeypatch.setattr(tracing, "_clock", clock)
    return now


@pytest.fixture
def recorded(monkeypatch: pytest.MonkeyPatch) -> list[tuple[str, str | None, dict[str, Any]]]:
    """Each span as it ends: (name, its parent's name, its attributes)."""
    out: list[tuple[str, str | None, dict[str, Any]]] = []
    exit_ = tracing.Span.__exit__

    def record(self: tracing.Span, *exc: Any) -> None:
        exit_(self, *exc)
        out.append((self.name, None if self.parent is None else self.parent.name, dict(self.attrs)))

    monkeypatch.setattr(tracing.Span, "__exit__", record)
    return out


def _spans(n: int) -> None:
    for _ in range(n):
        with span("refiners.off", program="p"):
            pass


def test_off_span_is_the_shared_noop_and_allocates_nothing(monkeypatch: pytest.MonkeyPatch) -> None:
    assert not tracing._on  # off by default
    assert span("refiners.off") is span("refiners.off", program="p") is tracing._NOOP

    def no_clock() -> int:
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(tracing, "_clock", no_clock)
    _spans(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        _spans(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before and peak - before < 1024  # nothing kept, nothing per call
    assert tracing.totals() == {}


def test_nesting_self_time_and_ids_on_a_fake_clock(fake_clock: list[int]) -> None:
    """A root opened at 0 with two children (10-20, 30-60, the second with
    a child 40-50), closed at 70: durations 70, 10, 30, 10; self 30, 10, 20,
    10. Children take their root's id: the one given, else the next drawn."""
    tracing.enable()
    with span("refiners.root", id=7) as root:
        with span("refiners.child", program="a") as first:
            pass
        with span("refiners.child", program="b") as second:
            with span("refiners.wait.leaf") as leaf:
                pass
    assert (root.start_ns, root.end_ns, second.start_ns, leaf.end_ns) == (0, 70, 30, 50)
    assert first.parent is root and second.parent is root and leaf.parent is second and root.parent is None
    assert {s.id for s in (root, first, second, leaf)} == {7}
    assert tracing.totals() == {
        "refiners.root": {"count": 1, "total_s": 70 / 1e9, "self_s": 30 / 1e9, "by": {}},
        "refiners.child": {"count": 2, "total_s": 40 / 1e9, "self_s": 30 / 1e9,
                           "by": {"program=a": {"count": 1, "total_s": 10 / 1e9, "self_s": 10 / 1e9},
                                  "program=b": {"count": 1, "total_s": 30 / 1e9, "self_s": 20 / 1e9}}},
        "refiners.wait.leaf": {"count": 1, "total_s": 10 / 1e9, "self_s": 10 / 1e9, "by": {}},
    }  # fmt: skip
    with span("refiners.root") as a, span("refiners.root") as inner:
        pass
    with span("refiners.root") as b:
        pass
    assert inner.id == a.id and b.id != a.id and 7 not in (a.id, b.id)


def test_reset_disable_and_spans_open_across_them(fake_clock: list[int]) -> None:
    tracing.enable()
    with span("refiners.a"):
        pass
    tracing.reset()
    assert tracing.totals() == {}
    with span("refiners.open"):
        tracing.disable()
        with span("refiners.inner") as inner:  # off: recorded by no one
            assert inner is None
    assert list(tracing.totals()) == ["refiners.open"]


def test_each_thread_nests_its_own_spans() -> None:
    tracing.enable()
    started, release = threading.Barrier(2), threading.Event()
    parents: dict[str, Any] = {}

    def worker(name: str) -> None:
        with span(f"refiners.{name}") as outer:
            started.wait(timeout=10)
            with span("refiners.inner") as inner:
                parents[name] = inner.parent is outer
            release.wait(timeout=10)

    threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    release.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert parents == {"a": True, "b": True}
    assert tracing.totals()["refiners.inner"]["count"] == 2


@pytest.fixture(scope="module")
def sd1() -> StableDiffusion_1:
    torch.manual_seed(0)
    return StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DDIM(num_inference_steps=1),
        device="cpu",
    )


def test_text_to_image_emits_the_documented_spans(sd1: StableDiffusion_1, recorded: list[Any]) -> None:
    """On the CPU the programs run eagerly: each shows its key's span alone."""
    pipe = TextToImage(sd1, size=(64, 64))
    plain = pipe("a cat", seed=3)
    tracing.enable()
    traced = pipe("a cat", seed=3)
    assert traced.tobytes() == plain.tobytes()
    call = "refiners.TextToImage.call"
    assert recorded == [
        ("refiners.TextToImage.encode", call, {}),
        ("refiners.Program.key", call, {"program": "TextToImage.diffuse"}),
        ("refiners.Program.key", call, {"program": "TextToImage.decode"}),
        ("refiners.wait.read_images", call, {}),
        ("refiners.TextToImage.to_images", call, {}),
        (call, None, {}),
    ]


class _Config(tu.BaseConfig):
    model: tu.ModelConfig


class _Trainer(tu.Trainer[_Config, Any]):
    @tu.register_model()
    def model(self, config: tu.ModelConfig) -> fl.Chain:
        return fl.Chain(fl.Linear(4, 4), fl.Linear(4, 4))

    def create_data_iterable(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        g = torch.Generator().manual_seed(0)
        return [(torch.randn(2, 4, generator=g), torch.randn(2, 4, generator=g)) for _ in range(4)]

    def compute_loss(self, batch: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return torch.mean((self.model(batch[0]) - batch[1]) ** 2)


def _trainer(jit_step: bool) -> _Trainer:
    return _Trainer(_Config.load_from_toml_string(f"""
[model]
requires_grad = true
[clock]
verbose = false
[training]
duration = "4:step"
device = "cpu"
gradient_accumulation = "2:step"
gradient_clipping_max_norm = 1.0
jit_step = {str(jit_step).lower()}
[optimizer]
optimizer = "AdamW"
learning_rate = 0.01
[lr_scheduler]
type = "ConstantLR"
"""))


@pytest.mark.parametrize("jit_step", [False, True])
def test_trainer_steps_emit_the_documented_spans(jit_step: bool, recorded: list[Any]) -> None:
    """Four steps, gradients accumulated over two: an optimizer step (with
    the norm's read) ends the second and the fourth; each step's id is the
    clock's step. Under ``jit_step`` the step program shows its key's span."""
    trainer = _trainer(jit_step)
    ids: list[int] = []
    enter = tracing.Span.__enter__

    def keep_id(self: tracing.Span) -> tracing.Span:
        out = enter(self)
        if self.parent is None:
            ids.append(self.id)
        return out

    tracing.enable()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(tracing.Span, "__enter__", keep_id)
        trainer.train()
    step, optimizer = "refiners.Trainer.step", "refiners.Trainer.optimizer_step"
    expected: list[Any] = []
    for i in range(4):
        if jit_step:
            expected.append(("refiners.Program.key", step, {"program": "Trainer.jit_step"}))
        if i % 2 == 1:
            expected += [("refiners.wait.grad_norm", optimizer, {}), (optimizer, step, {})]
        expected.append((step, None, {"id": i}))
    assert recorded == expected
    assert ids == [0, 1, 2, 3]


def test_spans_are_user_annotations_around_their_operations() -> None:
    """Under ``torch.profiler`` (CPU activity) each span is a kineto user
    annotation on the trace's clock: nested as recorded, each holding the
    aten operations launched inside it; off, no annotation is made."""
    x = torch.ones(8)
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("refiners.outer", id=5):
            y = x + 1
            with span("refiners.inner", program="p"):
                y = y * 2
        tracing.disable()
        with span("refiners.unseen"):
            y = y - 1
    events = prof.profiler.kineto_results.events()
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.is_user_annotation()}
    ops = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.name() in ("aten::add", "aten::mul", "aten::sub")}  # fmt: skip
    assert set(spans) == {"refiners.outer", "refiners.inner"}

    def inside(a: tuple[int, int], b: tuple[int, int]) -> bool:
        return b[0] <= a[0] and a[1] <= b[1]

    assert inside(spans["refiners.inner"], spans["refiners.outer"])
    assert inside(ops["aten::add"], spans["refiners.outer"]) and not inside(ops["aten::add"], spans["refiners.inner"])
    assert inside(ops["aten::mul"], spans["refiners.inner"])
    assert not inside(ops["aten::sub"], spans["refiners.outer"])
    assert set(tracing.totals()) == {"refiners.outer", "refiners.inner"}


def _span_calls(path: Path) -> list[tuple[str, str]]:
    """(enclosing function, span name) of each ``span("...")`` call in `path`."""
    out = []
    for fn in ast.walk(ast.parse(path.read_text())):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                    assert isinstance(node.args[0], ast.Constant), (path, node.lineno)
                    out.append((fn.name, node.args[0].value))
    return out


def test_every_span_is_named_and_placed_as_documented() -> None:
    """The port's spans sit in `Program`'s own methods, in
    `TextToImage.__call__` and in the Trainer's `step` and `backward`:
    never in a function that a program captures (`_diffuse`, `_decode`,
    `_loss_and_backward`, `Program._run`)."""
    found = {p.relative_to(PORT).as_posix(): sorted(set(_span_calls(p))) for p in PORT.rglob("*.py") if _span_calls(p)}
    program = "refiners.Program."
    assert found == {
        "fluxion/graphs.py": [
            ("__call__", program + "first_call"), ("__call__", program + "key"),
            ("_first_call", program + "capture"), ("_first_call", program + "eager"),
            ("_replay", program + "clone"), ("_replay", program + "copy_in"), ("_replay", program + "replay"),
        ],
        "pipelines.py": [
            ("__call__", "refiners.TextToImage.call"), ("__call__", "refiners.TextToImage.encode"),
            ("__call__", "refiners.TextToImage.to_images"), ("__call__", "refiners.wait.read_images"),
        ],
        "training_utils/trainer.py": [
            ("backward", "refiners.Trainer.optimizer_step"), ("backward", "refiners.wait.grad_norm"),
            ("step", "refiners.Trainer.step"),
        ],
    }  # fmt: skip


@pytest.mark.cuda
def test_first_calls_equal_captures_on_the_card() -> None:
    """Two shapes, three calls each: two first calls (each an eager run and
    a capture under it), four replays with their copy-in and clones, six
    key walks, all carrying the program's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    device = torch.device("cuda", 0)
    linear = torch.nn.Linear(16, 16, device=device)
    program = graphs.Program(lambda m, x: torch.relu(m(x)), name="tiny")
    tracing.enable()
    for rows in (4, 8):
        x = torch.randn(rows, 16, device=device)
        outs = [program(linear, x) for _ in range(3)]
        torch.testing.assert_close(outs[-1], torch.relu(linear(x)))
    torch.cuda.synchronize(device)
    totals = tracing.totals()
    counts = {name[len("refiners.Program."):]: t["count"] for name, t in totals.items()}
    assert counts == {"key": 6, "first_call": 2, "eager": 2, "capture": 2, "copy_in": 4, "replay": 4, "clone": 4}
    assert totals["refiners.Program.first_call"]["count"] == program.captures == 2
    assert all(set(t["by"]) == {"program=tiny"} for t in totals.values())
    first = totals["refiners.Program.first_call"]
    children = totals["refiners.Program.eager"]["total_s"] + totals["refiners.Program.capture"]["total_s"]
    assert first["self_s"] == pytest.approx(first["total_s"] - children)
