"""The port's ComfyUI nodes (`refiners_tpu_torch.comfyui`) against the JAX
package's (`comfyui_refiners_tpu`), on the CPU.

ComfyUI's ``IMAGE`` is a (B, H, W, C) torch tensor in [0, 1] and a ``MASK``
(B, H, W): the same on both sides, so node outputs compare directly. The
BoxSegmenter nodes run on `MVANet(depths=[1, 1, 1, 1])` at full width (its
only input size is 1024²), the port's weights bridged from the JAX model's,
each node loading its own package's safetensors file; the two masks may
differ by one 8-bit level where the packages' probabilities round to either
side of a half level (as in `tests/test_torch_swin_mvanet.py`), and the
port's node gives the direct `BoxSegmenter` call's mask bit for bit.
GroundingDINO and the Hub download run on stand-ins: the real ones need
files from the Hub.
"""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import comfyui_refiners_tpu as jax_nodes
import comfyui_refiners_tpu.box_segmenter as jax_box_segmenter
import comfyui_refiners_tpu.grounding_dino as jax_grounding_dino
import comfyui_refiners_tpu.huggingface as jax_huggingface
import comfyui_refiners_tpu.utils as jax_utils
import refiners_tpu.foundationals.swin.swin_transformer as jswin
import refiners_tpu_torch.comfyui as nodes
import refiners_tpu_torch.comfyui.box_segmenter as box_segmenter
import refiners_tpu_torch.comfyui.grounding_dino as grounding_dino
import refiners_tpu_torch.comfyui.huggingface as huggingface
import refiners_tpu_torch.comfyui.utils as utils
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.fluxion.utils import save_to_safetensors as jax_save_to_safetensors
from refiners_tpu.foundationals.swin.mvanet import MVANet as JaxMVANet
from refiners_tpu_torch.conversion import load_jax_state_dict
from refiners_tpu_torch.fluxion.utils import image_to_tensor, save_to_safetensors
from refiners_tpu_torch.foundationals.swin.mvanet import MVANet
from refiners_tpu_torch.solutions import BoxSegmenter as PortBoxSegmenter

PAIRS = [
    (box_segmenter.BoxSegmenter, jax_box_segmenter.BoxSegmenter),
    (box_segmenter.LoadBoxSegmenter, jax_box_segmenter.LoadBoxSegmenter),
    (grounding_dino.GroundingDino, jax_grounding_dino.GroundingDino),
    (grounding_dino.LoadGroundingDino, jax_grounding_dino.LoadGroundingDino),
    (utils.DrawBoundingBox, jax_utils.DrawBoundingBox),
    (huggingface.HfHubDownload, jax_huggingface.HfHubDownload),
]


def _comfy_image(seed: int, height: int, width: int) -> np.ndarray:
    """A ComfyUI IMAGE of 8-bit levels, (1, H, W, 3) float32 in [0, 1]."""
    levels = np.random.RandomState(seed).randint(0, 256, (1, height, width, 3), dtype=np.uint8)
    return levels.astype(np.float32) / 255.0


def test_node_class_mappings_match_jax() -> None:
    assert sorted(nodes.NODE_CLASS_MAPPINGS) == sorted(jax_nodes.NODE_CLASS_MAPPINGS)
    assert {name: cls.__name__ for name, cls in nodes.NODE_CLASS_MAPPINGS.items()} == {
        name: cls.__name__ for name, cls in jax_nodes.NODE_CLASS_MAPPINGS.items()
    }


@pytest.mark.parametrize("node,jax_node", PAIRS, ids=[p[0].__name__ for p in PAIRS])
def test_node_declarations_match_jax(node: Any, jax_node: Any) -> None:
    """Inputs, outputs, category and function as the JAX node declares
    them; the loaders default to the card where JAX's say "tpu" and "cpu"."""
    for attribute in ("RETURN_TYPES", "RETURN_NAMES", "DESCRIPTION", "CATEGORY", "FUNCTION"):
        assert getattr(node, attribute) == getattr(jax_node, attribute), attribute
    want = jax_node.INPUT_TYPES()
    if node in JAX_DEVICE_DEFAULTS:
        assert want["required"]["device"] == ("STRING", {"default": JAX_DEVICE_DEFAULTS[node]})
        want["required"]["device"] = ("STRING", {"default": "cuda"})
    assert node.INPUT_TYPES() == want


JAX_DEVICE_DEFAULTS = {box_segmenter.LoadBoxSegmenter: "tpu", grounding_dino.LoadGroundingDino: "cpu"}


@pytest.mark.parametrize("node", list(JAX_DEVICE_DEFAULTS), ids=lambda node: node.__name__)
def test_loader_nodes_default_to_the_card(node: Any) -> None:
    """Every node that places a model puts it on the card unless told otherwise."""
    assert node.INPUT_TYPES()["required"]["device"] == ("STRING", {"default": "cuda"})


def test_nodes_import_no_jax() -> None:
    """The nodes and the conversion code load without JAX or the JAX package."""
    code = (
        "import sys, refiners_tpu_torch.comfyui, refiners_tpu_torch.conversion.cli, "
        "refiners_tpu_torch.conversion.model_converter, refiners_tpu_torch.conversion.models.foundationals, "
        "refiners_tpu_torch.conversion.models.control_lora_sdxl, refiners_tpu_torch.conversion.models.loras\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'refiners_tpu', 'comfyui_refiners_tpu'))\n"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])


@pytest.mark.parametrize("color,width", [("red", 3), ("#00ff80", 1)])
def test_draw_bounding_box_matches_jax(color: str, width: int) -> None:
    image = _comfy_image(0, 40, 60)
    (got,) = utils.DrawBoundingBox().process(torch.from_numpy(image), (5, 8, 50, 30), color, width)
    (want,) = jax_utils.DrawBoundingBox().process(jnp.asarray(image), (5, 8, 50, 30), color, width)
    assert isinstance(got, torch.Tensor) and got.shape == (1, 40, 60, 3) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), image)


def test_nodes_take_one_image_like_jax() -> None:
    """A batch of two images raises in both packages' nodes: they take one."""
    images = np.concatenate([_comfy_image(1, 20, 30), _comfy_image(2, 20, 30)])
    with pytest.raises(AssertionError, match="batched"):
        utils.DrawBoundingBox().process(torch.from_numpy(images), (2, 2, 10, 10), "red", 1)
    with pytest.raises(AssertionError, match="batched"):
        jax_utils.DrawBoundingBox().process(jnp.asarray(images), (2, 2, 10, 10), "red", 1)


# ---------------------------------------------------------------------------
# the BoxSegmenter nodes
# ---------------------------------------------------------------------------

IMAGE_SIZE = (300, 200)  # (width, height)
BOX = (30, 20, 250, 180)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory: pytest.TempPathFactory) -> tuple[Path, Path]:
    """`MVANet(depths=[1, 1, 1, 1])` from a seed, saved by each package in its own layout."""
    folder = tmp_path_factory.mktemp("box_segmenter")
    jax_manual_seed(22)
    jax_model = JaxMVANet(depths=[1, 1, 1, 1])
    model = MVANet(depths=[1, 1, 1, 1])
    load_jax_state_dict(model, {k: np.asarray(v) for k, v in jax_model.state_dict().items()}, strict=True)
    jax_save_to_safetensors(folder / "jax.safetensors", jax_model.state_dict())
    save_to_safetensors(folder / "port.safetensors", model.state_dict())
    return folder / "port.safetensors", folder / "jax.safetensors"


@pytest.fixture
def reduced_mvanet(monkeypatch: pytest.MonkeyPatch) -> None:
    """Both packages' BoxSegmenters build `MVANet(depths=[1, 1, 1, 1])`."""
    monkeypatch.setattr("refiners_tpu_torch.solutions.box_segmenter.MVANet",
                        lambda device: MVANet(depths=[1, 1, 1, 1], device=device))  # fmt: skip
    monkeypatch.setattr("refiners_tpu.solutions.box_segmenter.MVANet", lambda: JaxMVANet(depths=[1, 1, 1, 1]))


def test_box_segmenter_nodes_match_jax(checkpoints: tuple[Path, Path], reduced_mvanet: None) -> None:
    port_file, jax_file = checkpoints
    image = _comfy_image(23, IMAGE_SIZE[1], IMAGE_SIZE[0])

    (model,) = box_segmenter.LoadBoxSegmenter().load(str(port_file), 0.05, "cpu")
    assert isinstance(model, PortBoxSegmenter) and model.margin == 0.05 and model.model.device == torch.device("cpu")
    recorded: list[tuple[np.ndarray, Image.Image]] = []
    predict = model.predict

    def record(crop: Image.Image) -> Image.Image:
        recorded.append((np.asarray(crop), predict(crop)))
        return recorded[-1][1]

    model.predict = record  # type: ignore[method-assign]
    (mask,) = box_segmenter.BoxSegmenter().process(model, torch.from_numpy(image), BOX)
    assert isinstance(mask, torch.Tensor) and mask.shape == (1, IMAGE_SIZE[1], IMAGE_SIZE[0])

    # the node's mask is the direct call's, bit for bit: the same crop reaches
    # the model (its prediction replayed, not computed again), the same paste
    def replay(crop: Image.Image) -> Image.Image:
        np.testing.assert_array_equal(np.asarray(crop), recorded[0][0])
        return recorded[0][1]

    model.predict = replay  # type: ignore[method-assign]
    direct = model(Image.fromarray((image[0] * 255).round().astype(np.uint8)), BOX)
    assert torch.equal(mask, image_to_tensor(direct)[:, 0])

    (jax_model,) = jax_box_segmenter.LoadBoxSegmenter().load(str(jax_file), 0.05, "cpu")
    jswin.get_attn_mask.cache_clear()  # the JAX package caches a tracer there when traced
    try:
        (jax_mask,) = jax_box_segmenter.BoxSegmenter().process(jax_model, jnp.asarray(image), BOX)
        jax.block_until_ready(jax_mask)
    finally:
        jswin.get_attn_mask.cache_clear()
    got, want = np.round(mask.numpy() * 255), np.round(np.asarray(jax_mask) * 255)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert got.max() > 0 and got.std() > 0


# ---------------------------------------------------------------------------
# GroundingDINO and the Hub download, on stand-ins
# ---------------------------------------------------------------------------


class _Inputs(dict):  # type: ignore[type-arg]
    def to(self, device: Any) -> "_Inputs":
        self.device = device
        return self


class StubProcessor:
    """Records what a node gives it; returns `boxes` as the detections."""

    def __init__(self, boxes: torch.Tensor) -> None:
        self.boxes = boxes
        self.calls: list[dict[str, Any]] = []

    def __call__(self, images: Image.Image, text: str, return_tensors: str) -> _Inputs:
        self.calls.append({"image": np.asarray(images), "text": text, "return_tensors": return_tensors})
        return _Inputs(input_ids=torch.tensor([[101, 7, 102]]), pixel_values=torch.zeros(1, 3, 4, 4))

    def post_process_grounded_object_detection(self, outputs: Any, input_ids: torch.Tensor, threshold: float,
                                               text_threshold: float, target_sizes: list[tuple[int, int]]) -> list[dict[str, Any]]:  # fmt: skip
        self.calls.append({"outputs": outputs, "input_ids": input_ids.tolist(), "threshold": threshold,
                           "text_threshold": text_threshold, "target_sizes": target_sizes})  # fmt: skip
        return [{"boxes": self.boxes}]


class StubModel:
    device = torch.device("cpu")

    def __call__(self, **inputs: torch.Tensor) -> dict[str, Any]:
        return {"inputs": sorted(inputs)}


@pytest.mark.parametrize("boxes", [
    [[-3.4, 10.6, 50.2, 60.7], [20.1, 5.5, 130.9, 40.2]],  # merged, clamped to the image
    [[10.5, 10.49, 30.51, 29.5]],
])  # fmt: skip
def test_grounding_dino_matches_jax(boxes: list[list[float]]) -> None:
    image = _comfy_image(3, 80, 120)
    processor, jax_processor = StubProcessor(torch.tensor(boxes)), StubProcessor(torch.tensor(boxes))
    (got,) = grounding_dino.GroundingDino().process(processor, StubModel(), torch.from_numpy(image), "a cat", 0.3, 0.2)
    (want,) = jax_grounding_dino.GroundingDino().process(jax_processor, StubModel(), jnp.asarray(image), "a cat", 0.3, 0.2)
    assert got == want and all(isinstance(v, int) for v in got)
    for call, jax_call in zip(processor.calls, jax_processor.calls, strict=True):
        assert call.keys() == jax_call.keys()
        for key in call:
            if key == "image":
                np.testing.assert_array_equal(call[key], jax_call[key])
            else:
                assert call[key] == jax_call[key], key


def test_grounding_dino_refuses_an_image_without_detections() -> None:
    empty = torch.zeros(0, 4)
    image = torch.from_numpy(_comfy_image(4, 16, 16))
    with pytest.raises(AssertionError, match="no object detected"):
        grounding_dino.GroundingDino().process(StubProcessor(empty), StubModel(), image, "nothing", 0.3, 0.3)


def test_load_grounding_dino_matches_jax(monkeypatch: pytest.MonkeyPatch) -> None:
    """`transformers` imported when the node loads: a stand-in module here,
    whose classes record what they are given (no file, no Hub)."""

    class Processor:
        @classmethod
        def from_pretrained(cls, checkpoint: str) -> str:
            return f"processor:{checkpoint}"

    class Detector:
        def __init__(self, checkpoint: str, dtype: Any) -> None:
            self.checkpoint, self.dtype, self.device = checkpoint, dtype, None

        @classmethod
        def from_pretrained(cls, checkpoint: str, torch_dtype: Any) -> "Detector":
            return cls(checkpoint, torch_dtype)

        def to(self, device: str) -> "Detector":
            self.device = device
            return self

    stand_in = types.ModuleType("transformers")
    stand_in.GroundingDinoProcessor = Processor  # type: ignore[attr-defined]
    stand_in.GroundingDinoForObjectDetection = Detector  # type: ignore[attr-defined]
    monkeypatch.setitem(sys.modules, "transformers", stand_in)
    got = grounding_dino.LoadGroundingDino().load("some/dir", "bfloat16", "cpu")
    want = jax_grounding_dino.LoadGroundingDino().load("some/dir", "bfloat16", "cpu")
    assert got[0] == want[0] == "processor:some/dir"
    assert (got[1].checkpoint, got[1].dtype, got[1].device) == (want[1].checkpoint, want[1].dtype, want[1].device)
    assert got[1].dtype == torch.bfloat16 and got[1].device == "cpu"


@pytest.mark.parametrize("filename", ["model.safetensors", ""])
def test_hf_hub_download_matches_jax(filename: str, monkeypatch: pytest.MonkeyPatch, tmp_path: Path) -> None:
    """`huggingface_hub` imported when the node downloads: a stand-in module here."""
    stand_in = types.ModuleType("huggingface_hub")
    stand_in.hf_hub_download = lambda repo_id, filename, revision: str(tmp_path / repo_id / revision / filename)  # type: ignore[attr-defined]
    stand_in.snapshot_download = lambda repo_id, revision: str(tmp_path / repo_id / revision) + "/"  # type: ignore[attr-defined]
    monkeypatch.setitem(sys.modules, "huggingface_hub", stand_in)
    got = huggingface.HfHubDownload().download("org/model", filename, revision="v1")
    want = jax_huggingface.HfHubDownload().download("org/model", filename, revision="v1")
    assert got == want == (str(tmp_path / "org" / "model" / "v1" / filename).removesuffix("/"),)
