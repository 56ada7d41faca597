"""The comparison that decides ``correct`` is shown to fail, on the CPU at
tiny sizes.

- The control: the reference computed with every product's inputs rounded
  to float8, put in the program's place, fails the serving cells' limits
  where the bf16 program passes them, and the tiny training cell's where
  the float32 program passes them.
- Faults planted under a whole run (the harness's look for a card
  skipped): an answer altered where it is produced, a denoising step or an
  optimizer step that returns its state unchanged, half of the batch left
  out and the mean taken over the rest. Each run comes out not correct.
  (No cell crosses chips, so there is no exchange between chips to leave
  out.)

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import pytest
import torch

from h100_bench import bench
from h100_bench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def checkout() -> Path:
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.copy_bench(Path(tmp))


def _limits(cell: str) -> dict[str, float]:
    return bench.load_json(bench.BENCH / "workloads" / f"{cell}.json")["check"]


def _bf16(checkout: Path, cell: str) -> bench.Cell:
    c = tiny.cell(checkout, cell)
    (checkout / "configs" / f"{c.config_name}.json").write_text(json.dumps(tiny.tiny_config(c.config_name, "bfloat16")))
    return tiny.cell(checkout, cell)


@pytest.mark.parametrize(("cell", "limits_of"), [("tiny-sd15-b1", "sd15-512-b1"), ("tiny-sdxl-b1", "sdxl-1024-b1")])
def test_serving_control_fails_where_the_program_passes(checkout: Path, cell: str, limits_of: str) -> None:
    c = _bf16(checkout, cell)
    driver = c.driver().Driver(c, 2**35 + 9, CPU)
    driver.setup()
    driver.latents.clear()
    for _ in range(2):
        request = driver.next_request()
        driver.images.append(np.asarray(driver.serve(*request)))
        driver.requests.append(request)
    driver.window_latents = driver.latents[:]
    reference = driver.reference([0, 1])
    gaps = c.driver().gaps
    served = [{"latents": z, "decoded": image} for z, image in zip(driver.window_latents, driver.images)]
    program, control = gaps(served, reference, CPU), gaps(driver.reference([0, 1], fp8=True), reference, CPU)
    limits = _limits(limits_of)
    assert program["decode_rms"] <= limits["decode_rms"], program
    assert any(control[k] > limits[k] for k in limits), control


def test_training_control_fails_where_the_program_passes(checkout: Path) -> None:
    """At the tiny size a bf16 model's small leaves read far above the
    card's full-width readings, so this holds the float32 program to the
    tiny cell's own limits, which the control fails."""
    c = tiny.cell(checkout, "tiny-sd15-train")
    (checkout / "configs" / f"{c.config_name}.json").write_text(json.dumps(tiny.tiny_config(c.config_name)))
    c = tiny.cell(checkout, "tiny-sd15-train")
    driver = c.driver().Driver(c, 2**35 + 11, CPU)
    driver.setup()
    reference = driver.reference()
    gaps = c.driver().gaps
    program, control = gaps(driver.readings, reference), gaps(driver.reference(fp8=True), reference)
    limits = c.workload["check"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


def _altered_image(monkeypatch: pytest.MonkeyPatch) -> None:
    from refiners_tpu_torch import pipelines

    to_images = pipelines.tensor_to_images
    monkeypatch.setattr(pipelines, "tensor_to_images", lambda x: to_images(x.flip(-1)))


def _denoising_step_unchanged(monkeypatch: pytest.MonkeyPatch) -> None:
    from refiners_tpu_torch.foundationals.latent_diffusion.solvers import DDIM

    monkeypatch.setattr(DDIM, "__call__", lambda self, x, predicted_noise, step, generator=None: x)


def _half_of_the_batch(monkeypatch: pytest.MonkeyPatch) -> None:
    """The U-Net on the first half of the CFG batch, its result standing for both halves."""
    from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel

    rows = LatentDiffusionModel._unet_rows

    def half(self: Any, latents: torch.Tensor, step: int, **context: torch.Tensor) -> torch.Tensor:
        n = latents.shape[0] // 2
        context = {k: v[:n] if isinstance(v, torch.Tensor) and v.shape[0] == 2 * n else v for k, v in context.items()}
        return rows(self, latents[:n], step, **context).repeat(2, 1, 1, 1)

    monkeypatch.setattr(LatentDiffusionModel, "_unet_rows", half)


def _optimizer_step_unchanged(monkeypatch: pytest.MonkeyPatch) -> None:
    """AdamW's step runs (its moments move) and the parameters are put back."""
    step = torch.optim.AdamW.step

    def unchanged(self: Any, closure: Any = None) -> None:
        params = [p for group in self.param_groups for p in group["params"]]
        kept = [p.detach().clone() for p in params]
        step(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)

    monkeypatch.setattr(torch.optim.AdamW, "step", unchanged)


def _half_of_the_training_batch(monkeypatch: pytest.MonkeyPatch) -> None:
    from refiners_tpu_torch.training_utils.trainer import Trainer

    loss_and_backward = Trainer._loss_and_backward

    def half(self: Any, modules: Any, batch: dict[str, torch.Tensor], accum: int, generators: Any) -> torch.Tensor:
        n = batch["latents"].shape[0] // 2
        return loss_and_backward(self, modules, {k: v[:n] for k, v in batch.items()}, accum, generators)

    monkeypatch.setattr(Trainer, "_loss_and_backward", half)


@pytest.mark.parametrize(
    ("cell", "fault"),
    [
        ("tiny-sd15-b1", _altered_image),
        ("tiny-sd15-b1", _denoising_step_unchanged),
        ("tiny-sd15-b1", _half_of_the_batch),
        ("tiny-sdxl-lora2", _altered_image),
        ("tiny-sd15-train", _optimizer_step_unchanged),
        ("tiny-sd15-train", _half_of_the_training_batch),
    ],
)
def test_a_planted_fault_is_not_correct(checkout: Path, monkeypatch: pytest.MonkeyPatch, cell: str, fault: Any) -> None:
    c = tiny.cell(checkout, cell)
    (checkout / "configs" / f"{c.config_name}.json").write_text(json.dumps(tiny.tiny_config(c.config_name)))
    fault(monkeypatch)
    result = bench.run_cell(tiny.cell(checkout, cell), 2**36 + 5, 0.2, False, CPU, 0.0)
    assert not result["correct"], result["check"]
