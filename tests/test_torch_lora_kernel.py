"""`LoraAdapter`'s kernel route and the LoRA kernel of `ops.lora`.

On the CPU: `lora_add_plain` against the adapter's `Sum` in float32, which
route each adapter takes, the route's forward (with the plain version in the
kernel's place) against the `Sum`, and the adapter's structure kept. On the
card (`-m cuda`, skipped elsewhere): the kernel against its plain version
in float32, and the route launching it once per call. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_lora_kernel.py -q
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path
from typing import Any

import pytest
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters import Conv2dLora, LinearLora, LoraAdapter
from refiners_tpu_torch.fluxion.adapters import lora as adapters_lora
from refiners_tpu_torch.ops import lora

PORT = Path(__file__).resolve().parents[1] / "refiners_tpu_torch"
SCALES = (1.0, 0.5, 0.7)


def _linear_adapter(ranks: tuple[int, ...], dtype: torch.dtype = torch.float32, in_features: int = 24,
                    out_features: int = 16, seed: int = 0) -> tuple[fl.Chain, LoraAdapter]:  # fmt: skip
    """Chain(Linear) with an adapter of LoRAs of `ranks`, drawn from `seed`
    (up drawn too: a fresh LoRA's up is zero), at `SCALES`."""
    gen = torch.Generator().manual_seed(seed)
    chain = fl.Chain(fl.Linear(in_features, out_features, dtype=dtype))
    with torch.no_grad():
        for p in chain.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    loras = []
    for i, rank in enumerate(ranks):
        down = torch.randn((rank, in_features), generator=gen) * rank**-0.5
        up = torch.randn((out_features, rank), generator=gen) * 0.3
        loras.append(LinearLora.from_weights(f"l{i}", down=down.to(dtype), up=up.to(dtype)))
        loras[-1].scale = SCALES[i % len(SCALES)]
    adapter = LoraAdapter(chain.Linear, *loras).inject(chain)
    return chain, adapter


def _operands(adapter: LoraAdapter) -> tuple[list[torch.Tensor], list[torch.Tensor], list[float]]:
    loras = list(adapter.lora_layers)
    return [l.down.weight for l in loras], [l.up.weight for l in loras], [l.scale for l in loras]


@pytest.fixture
def route_on_cpu(monkeypatch: pytest.MonkeyPatch) -> list[int]:
    """The route's checks asked of the CPU and the plain version in the
    kernel's place, so that the kernel route runs here; the list counts its
    calls."""
    calls: list[int] = []

    def plain(*args: Any) -> torch.Tensor:
        calls.append(1)
        return lora.lora_add_plain(*args)

    monkeypatch.setattr(adapters_lora, "refusal", functools.partial(lora.refusal, device_type="cpu"))
    monkeypatch.setattr(adapters_lora, "lora_add_", plain)
    return calls


@pytest.mark.parametrize("x_shape", [(5, 24), (2, 7, 24)], ids=["2d", "3d"])
@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("rank", [16, 32])
def test_plain_matches_the_sum_in_float32(rank: int, count: int, x_shape: tuple[int, ...]) -> None:
    """y = target(x) then `lora_add_plain` equals the adapter's `Sum` of the
    target and its `Chain(down, up, Multiply)` branches, at scales 1.0, 0.5
    and 0.7."""
    chain, adapter = _linear_adapter((rank,) * count, seed=rank + count)
    x = torch.randn(x_shape, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = chain(x)
        y = adapter.target(x)
        got = lora.lora_add_plain(y, x, *_operands(adapter))
    assert got is y
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_lora_add_on_the_cpu_is_the_plain_version() -> None:
    _, adapter = _linear_adapter((4, 8), dtype=torch.bfloat16)
    x = torch.randn((3, 24)).to(torch.bfloat16)
    y = adapter.target(x)
    want = lora.lora_add_plain(y.clone(), x, *_operands(adapter))
    before = lora.lora_add_.launches
    assert torch.equal(lora.lora_add_(y, x, *_operands(adapter)), want)
    assert lora.lora_add_.launches == before


def test_route_predicate(monkeypatch: pytest.MonkeyPatch) -> None:
    """A plain Linear with LinearLoras, 16-bit, no gradient wanted, takes the
    kernel route; a Conv2dLora, a LoRA being trained, mixed dtypes, float32,
    the CPU and anything the kernel refuses take the `Sum`."""
    bf16 = torch.bfloat16
    x = torch.randn((3, 24)).to(bf16)
    _, adapter = _linear_adapter((8, 8), dtype=bf16)
    with torch.no_grad():
        assert adapter._kernel_operands(x) is None  # the CPU
    monkeypatch.setattr(adapters_lora, "refusal", functools.partial(lora.refusal, device_type="cpu"))
    with torch.no_grad():
        name, target, downs, ups, scales = adapter._kernel_operands(x)
    assert target is adapter.target and adapter[name] is target and scales == [1.0, 0.5]
    assert [d.data_ptr() for d in downs] == [l.down.weight.data_ptr() for l in adapter.lora_layers]
    assert [u.data_ptr() for u in ups] == [l.up.weight.data_ptr() for l in adapter.lora_layers]
    with torch.inference_mode():
        assert adapter._kernel_operands(x) is not None

    # a LoRA being trained: its weights require grad (a new parameter's default) with the gradient wanted
    assert adapter._kernel_operands(x) is None
    for lora_layer in adapter.lora_layers:
        lora_layer.requires_grad_(False)
    assert adapter._kernel_operands(x) is not None  # frozen LoRAs, x not requiring grad: no gradient wanted
    assert adapter._kernel_operands(x.requires_grad_()) is None
    x = x.detach()
    # float32, and mixed dtypes
    _, f32 = _linear_adapter((8,))
    assert f32._kernel_operands(x.float()) is None
    assert adapter._kernel_operands(x.to(torch.float16)) is None
    _, mixed = _linear_adapter((8,), dtype=bf16)
    mixed.target.to(torch.float16)
    with torch.no_grad():
        assert mixed._kernel_operands(x) is None
    # a Conv2d target and its LoRA
    conv = fl.Chain(fl.Conv2d(4, 8, kernel_size=1, dtype=bf16))
    conv_adapter = LoraAdapter(conv.Conv2d, Conv2dLora("c", 4, 8, rank=2, kernel_size=(1, 1), padding=(0, 0),
                                                       dtype=bf16)).inject(conv)  # fmt: skip
    with torch.no_grad():
        assert conv_adapter._kernel_operands(torch.randn((1, 4, 3, 3)).to(bf16)) is None
    # what the kernel refuses: more than 4 LoRAs, out features not a multiple of 8, a biased branch
    with torch.no_grad():
        assert _linear_adapter((4,) * 5, dtype=bf16)[1]._kernel_operands(x) is None
        assert _linear_adapter((4,), dtype=bf16, out_features=12)[1]._kernel_operands(x) is None
        _, biased = _linear_adapter((4,), dtype=bf16)
        next(iter(biased.lora_layers)).ensure_find(fl.Multiply).bias = 0.25
        assert biased._kernel_operands(x) is None


@pytest.mark.parametrize("x_shape", [(5, 24), (2, 7, 24)], ids=["2d", "3d"])
def test_kernel_route_forward_matches_the_sum(route_on_cpu: list[int], x_shape: tuple[int, ...]) -> None:
    """The route's forward (target, then the LoRAs added in place) against
    the `Sum`, in bfloat16 on the CPU; a transposed x as the transformers'
    `proj_in` gets."""
    bf16 = torch.bfloat16
    chain, adapter = _linear_adapter((8, 16, 4), dtype=bf16)
    x = torch.randn(x_shape, generator=torch.Generator().manual_seed(3)).to(bf16)
    if len(x_shape) == 3:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with torch.no_grad():
        got = chain(x)
        assert route_on_cpu == [1]
        downs, ups, scales = _operands(adapter)
        want = adapter.target(x).float() + sum(s * (x.float() @ d.float().t()) @ u.float().t()
                                               for d, u, s in zip(downs, ups, scales))  # fmt: skip
        sum_route = fl.Sum.forward(adapter, x)
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=8e-3)
    torch.testing.assert_close(got.float(), sum_route.float(), rtol=3e-2, atol=3e-2)


def test_structure_unchanged_by_the_kernel_route(route_on_cpu: list[int]) -> None:
    """The adapter's `state_dict()` keys and `repr` are those of the `Sum`
    it is, before and after kernel-route calls, and ejecting restores the
    base output bit for bit."""
    bf16 = torch.bfloat16
    chain = fl.Chain(fl.Linear(24, 16, dtype=bf16))
    x = torch.randn((3, 24)).to(bf16)
    with torch.no_grad():
        base = chain(x)
    keys, text = list(chain.state_dict()), repr(chain)
    loras = [LinearLora("a", 24, 16, rank=8, dtype=bf16), LinearLora("b", 24, 16, rank=4, dtype=bf16)]
    adapter = LoraAdapter(chain.Linear, *loras).inject(chain)
    adapted_keys, adapted_text = list(chain.state_dict()), repr(chain)
    with torch.no_grad():
        assert torch.equal(chain(x), base)  # a fresh LoRA's up is zero
        assert route_on_cpu == [1]
    assert list(chain.state_dict()) == adapted_keys and repr(chain) == adapted_text
    assert adapted_keys == ["LoraAdapter.Linear.weight", "LoraAdapter.Linear.bias",
                            "LoraAdapter.LinearLora_1.Linear_1.weight", "LoraAdapter.LinearLora_1.Linear_2.weight",
                            "LoraAdapter.LinearLora_2.Linear_1.weight", "LoraAdapter.LinearLora_2.Linear_2.weight"]  # fmt: skip
    adapter.eject()
    assert list(chain.state_dict()) == keys and repr(chain) == text
    with torch.no_grad():
        assert torch.equal(chain(x), base)


def test_changes_after_a_call_are_honoured(route_on_cpu: list[int]) -> None:
    """A scale set, a LoRA added and a LoRA removed after a first call are
    read at the next call: nothing is kept from one call to the next."""
    bf16 = torch.bfloat16
    chain, adapter = _linear_adapter((8, 8), dtype=bf16)
    x = torch.randn((4, 24), generator=torch.Generator().manual_seed(5)).to(bf16)

    def expected() -> torch.Tensor:
        with torch.no_grad():
            return lora.lora_add_plain(adapter.target(x), x, *_operands(adapter))

    with torch.no_grad():
        first = chain(x)
        assert torch.equal(first, expected())
        adapter.scale = {"l0": 0.25, "l1": -1.5}
        assert torch.equal(chain(x), expected()) and not torch.equal(chain(x), first)
        extra = LinearLora.from_weights("extra", down=torch.randn((4, 24)).to(bf16), up=torch.randn((16, 4)).to(bf16))
        adapter.add_lora(extra)
        assert torch.equal(chain(x), expected())
        assert adapter.remove_lora("l0") is not None
        assert torch.equal(chain(x), expected())
    assert len(route_on_cpu) == 5


def _calls_in(fn: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            names.add(func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", ""))
    return names


def test_no_span_in_the_captured_forward() -> None:
    """`Program` captures `LoraAdapter.forward` (a span there would run at
    capture and never at replay): the tracing tests' source walk covers its
    file, and neither the forward nor what it calls in `ops.lora` opens a
    span."""
    files = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"fluxion/adapters/lora.py", "ops/lora.py"} <= files
    tree = ast.parse((PORT / "fluxion/adapters/lora.py").read_text())
    adapter = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef) and n.name == "LoraAdapter")
    methods = {n.name: n for n in adapter.body if isinstance(n, ast.FunctionDef)}
    assert {"forward", "_kernel_operands"} <= set(methods)
    for name in ("forward", "_kernel_operands"):
        assert "span" not in _calls_in(methods[name]), name
    assert "span" not in _calls_in(ast.parse((PORT / "ops/lora.py").read_text()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


# (leading shape of x and y, in, out, ranks, scales)
KERNEL_CASES = [
    ((2048,), 1280, 1280, (32, 32), (1.0, 0.5)),  # the SDXL UNet's 1280-wide projections
    ((300,), 96, 136, (4, 12, 40), (0.7, -1.5, 2.0)),  # ragged rows and columns; ranks off 8 and 16
    ((1,), 64, 8, (1,), (1.0,)),
    ((129,), 128, 264, (16, 16, 16, 16), (1.0, 0.5, 0.25, -0.75)),  # four LoRAs
    ((77,), 256, 640, (128, 128, 128, 128), (0.1, 0.2, 0.3, 0.4)),  # the most K steps the kernel takes
    ((2, 154), 64, 640, (32, 32), (1.0, 0.5)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[f"{c[0]}x{c[1]}-{c[2]}-r{c[3]}" for c in KERNEL_CASES])
def test_kernel_matches_plain(device: torch.device, case: tuple, dtype: torch.dtype) -> None:
    """The kernel (with its down products) against the plain version in
    float32 on the same inputs: the down products and the scaled H rounded
    to the input type, the output rounded once (unit roundoff 3.9e-3 in
    bf16)."""
    lead, fin, fout, ranks, scales = case
    gen = torch.Generator(device).manual_seed(fin + fout)
    x = torch.randn((*lead, fin), generator=gen, device=device).to(dtype)
    y0 = torch.randn((*lead, fout), generator=gen, device=device).to(dtype)
    downs = [(torch.randn((r, fin), generator=gen, device=device) * fin**-0.5).to(dtype) for r in ranks]
    ups = [(torch.randn((fout, r), generator=gen, device=device) * r**-0.5).to(dtype) for r in ranks]
    want = lora.lora_add_plain(y0.float(), x.float(), [d.float() for d in downs], [u.float() for u in ups], scales)
    before = lora.lora_add_.launches
    y = y0.clone()
    assert lora.lora_add_(y, x, downs, ups, scales) is y
    torch.cuda.synchronize()
    assert lora.lora_add_.launches == before + 1
    assert torch.isfinite(y).all()
    assert _rel(y, want) <= 1e-2
    # elementwise: y's own rounding, plus a few roundings of the LoRAs' part (H and s·H in the input type)
    eps = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-11
    delta = float((want - y0.float()).abs().max())
    assert ((y.float() - want).abs() <= want.abs() * eps + 3e-2 * delta).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[f"{c[0]}x{c[1]}-{c[2]}-r{c[3]}" for c in KERNEL_CASES])
def test_down_kernel_matches_the_products(device: torch.device, case: tuple) -> None:
    """H: LoRA i's columns, from the next multiple of 16, hold sᵢ x Dᵢᵀ
    (float32 sums of bf16 products, scaled, rounded once to bf16)."""
    lead, fin, _, ranks, scales = case
    gen = torch.Generator(device).manual_seed(fin)
    rows = torch.randn((int(torch.tensor(lead).prod()), fin), generator=gen, device=device).to(torch.bfloat16)
    downs = [torch.randn((r, fin), generator=gen, device=device).to(torch.bfloat16) for r in ranks]
    h = lora.down(rows, downs, scales)
    assert h.shape == (rows.shape[0], lora.h_width(ranks)) and h.dtype == torch.bfloat16
    offset = 0
    for d, s in zip(downs, scales):
        want = s * (rows.float() @ d.float().t())
        got = h[:, offset : offset + d.shape[0]].float()
        assert (got - want).abs().max() <= 2.0**-8 * want.abs().max() + 1e-4 * fin**0.5
        offset += -(-d.shape[0] // 16) * 16


@pytest.mark.cuda
def test_kernel_reads_a_transposed_x_and_scale_zero_is_the_identity(device: torch.device) -> None:
    """x as a transformer's `proj_in` gets it, (B, HW, C) transposed from
    (B, C, HW); at scale 0 every LoRA leaves y bit for bit."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device).manual_seed(11)
    x = torch.randn((2, 640, 1024), generator=gen, device=device).to(bf16).transpose(1, 2)
    y0 = torch.randn((2, 1024, 640), generator=gen, device=device).to(bf16)
    downs = [(torch.randn((32, 640), generator=gen, device=device) * 0.04).to(bf16) for _ in range(2)]
    ups = [(torch.randn((640, 32), generator=gen, device=device) * 0.2).to(bf16) for _ in range(2)]
    want = lora.lora_add_plain(y0.float(), x.float(), [d.float() for d in downs], [u.float() for u in ups], (1.0, 0.5))
    y = lora.lora_add_(y0.clone(), x, downs, ups, (1.0, 0.5))
    assert _rel(y, want) <= 1e-2
    assert torch.equal(lora.lora_add_(y0.clone(), x, downs, ups, (0.0, 0.0)), y0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(device: torch.device) -> None:
    bf16 = torch.bfloat16
    x = torch.randn((16, 32), device=device, dtype=bf16)
    down, up = torch.randn((4, 32), device=device, dtype=bf16), torch.randn((64, 4), device=device, dtype=bf16)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        lora.lora_add_(torch.zeros((16, 64), device=device), x.float(), [down.float()], [up.float()], [1.0])
    buffer = torch.zeros(16 * 64 + 1, device=device, dtype=bf16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        lora.lora_add_(buffer[1:].view(16, 64), x, [down], [up], [1.0])
    with pytest.raises(ValueError, match="1 to 4 LoRAs"):
        lora.lora_add_(torch.zeros((16, 64), device=device, dtype=bf16), x, [down] * 5, [up] * 5, [1.0] * 5)


@pytest.mark.cuda
def test_adapter_routes_through_the_kernel(device: torch.device) -> None:
    """A bf16 adapter on the card launches the kernel once per call and
    agrees with its own `Sum` in float32; a float32 one runs the `Sum`."""
    chain, adapter = _linear_adapter((8, 8), dtype=torch.bfloat16, in_features=64, out_features=128)
    chain.to(device)
    x = torch.randn((2, 50, 64), device=device).to(torch.bfloat16)
    before = lora.lora_add_.launches
    with torch.inference_mode():
        got = chain(x)
        assert lora.lora_add_.launches == before + 1
        chain.to(dtype=torch.float32)
        want = chain(x.float())
        assert lora.lora_add_.launches == before + 1
    assert _rel(got, want) <= 1e-2
