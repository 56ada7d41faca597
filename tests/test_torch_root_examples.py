"""The port's counterparts of the two root examples, on the CPU.

``refiners_tpu_torch/examples/txt2img.py`` and ``controlnet_lora.py``
through their ``main([..., "--device", "cpu"])``: a reduced SD1.5
(`SD1UNet(base_channels=32)`, a 2-layer CLIP-L, the SD1 VAE) and a reduced
SDXL (`SDXLUNet(base_channels=32)`, one-layer CLIP-L and CLIP-G, the SDXL
VAE) in bfloat16, their state dicts written to safetensors under the
stems the examples read, with a seeded ControlNet at the reduced UNet's
widths and a LoRA; 2 DDIM steps at 64². The examples build the full-width
models (`txt2img.build_model`, checked on the meta device); here they
build the reduced ones, from another seed, so that every weight comes from
the files. Each image equals `TextToImage` called directly on the same
weights and seed; `controlnet_lora` places its model on a mesh of one gloo
rank that it starts and ends itself.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Any

import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.examples import controlnet_lora, txt2img
from refiners_tpu_torch.fluxion import manual_seed
from refiners_tpu_torch.fluxion.utils import image_to_tensor, load_from_safetensors, save_to_safetensors
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTokenizer
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DoubleTextEncoder,
    SD1Autoencoder,
    SD1ControlnetAdapter,
    SD1UNet,
    SDLoraManager,
    SDXLAutoencoder,
    SDXLUNet,
    StableDiffusion_1,
    StableDiffusion_XL,
)
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.controlnet import Controlnet
from refiners_tpu_torch.pipelines import TextToImage

ROOT = Path(__file__).resolve().parents[1]
STEPS, SIZE, SEED = 2, 64, 7
PROMPT = "a lighthouse at dawn"
RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _reduced(model: str, steps: int, device: str) -> Any:
    """The reduced model of `model` in bfloat16 on `device`, DDIM at `steps`."""
    if model == "sdxl":
        text_l = CLIPTextEncoder(embedding_dim=768, num_layers=1, num_attention_heads=12, use_quick_gelu=True)
        text_g = CLIPTextEncoder(embedding_dim=1280, num_layers=1, num_attention_heads=20, tokenizer=CLIPTokenizer(pad_token_id=0))
        return StableDiffusion_XL(
            unet=SDXLUNet(in_channels=4, base_channels=32), lda=SDXLAutoencoder(),
            clip_text_encoder=DoubleTextEncoder(text_encoder_l=text_l, text_encoder_g=text_g),
            solver=DDIM(num_inference_steps=steps, device=device), device=device, dtype=torch.bfloat16,
        )  # fmt: skip
    return StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32), lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12, use_quick_gelu=True),
        solver=DDIM(num_inference_steps=steps, device=device), device=device, dtype=torch.bfloat16,
    )  # fmt: skip


def _lora_weights(sd: StableDiffusion_1, seed: int) -> dict[str, torch.Tensor]:
    """A CivitAI-style LoRA in the reference layout (`tests/test_torch_lora.py`'s
    `_sd_lora_dict`): every Linear of the UNet's transformer blocks and of CLIP."""
    gen = torch.Generator().manual_seed(seed)
    linears = [("unet_L", l) for b in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in b.layers(fl.Linear, recurse=True)]
    linears += [("text_T", l) for l in sd.clip_text_encoder.layers(fl.Linear, recurse=True)]
    weights: dict[str, torch.Tensor] = {}
    for n, (prefix, linear) in enumerate(linears):
        weights[f"lora_{prefix}{n:04d}.lora_down.weight"] = torch.randn((RANK, linear.in_features), generator=gen) * 0.1
        weights[f"lora_{prefix}{n:04d}.lora_up.weight"] = torch.randn((linear.out_features, RANK), generator=gen) * 0.1
    return weights


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory: pytest.TempPathFactory) -> Path:
    """The reduced models' files under the examples' stems, a ControlNet, a LoRA and a 64² condition."""
    folder = tmp_path_factory.mktemp("weights")
    for model in ("sd15", "sdxl"):
        manual_seed(1)
        sd = _reduced(model, STEPS, "cpu")
        for attr, stem in txt2img.STEMS[model].items():
            save_to_safetensors(folder / f"{stem}.safetensors", getattr(sd, attr).state_dict())
        if model == "sd15":
            manual_seed(2)
            controlnet = Controlnet(name="canny", base_channels=32, dtype=torch.bfloat16)
            save_to_safetensors(folder / "controlnet.sd15.canny.safetensors", controlnet.state_dict())
            save_to_safetensors(folder / "lora.safetensors", _lora_weights(sd, seed=3))
    condition = (np.random.RandomState(4).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    Image.fromarray(condition).save(folder / "canny.png")
    return folder


@pytest.fixture
def built(monkeypatch: pytest.MonkeyPatch) -> list[Any]:
    """`txt2img.build_model` building the reduced models (from another seed
    than the files'); the models it built."""
    models: list[Any] = []

    def build(model: str, steps: int, device: str) -> Any:
        manual_seed(99)
        models.append(_reduced(model, steps, device))
        return models[-1]

    monkeypatch.setattr(txt2img, "build_model", build)
    return models


def _loaded(model: str, weights_dir: Path) -> Any:
    manual_seed(99)
    sd = _reduced(model, STEPS, "cpu")
    txt2img.load_weights(sd, weights_dir, model)
    return sd


def _add_options(path: Path) -> list[str]:
    """The options an example's `main` declares (`p.add_argument("--…")`), read with `ast`."""
    tree = ast.parse(path.read_text())
    return [
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_argument"
        and isinstance(node.args[0], ast.Constant)
    ]  # fmt: skip


@pytest.mark.parametrize("name", ["txt2img", "controlnet_lora"])
def test_arguments_are_the_jax_examples_and_device(name: str) -> None:
    want = _add_options(ROOT / "examples" / f"{name}.py")
    assert _add_options(ROOT / "refiners_tpu_torch" / "examples" / f"{name}.py") == [*want, "--device"]
    jax_text = (ROOT / "examples" / f"{name}.py").read_text()
    stems = [stem for model in ("sd15", "sdxl") for stem in txt2img.STEMS[model].values()]
    assert all(f'"{stem}' in jax_text for stem in stems if name == "txt2img" or stem.startswith("sd15"))


@pytest.mark.parametrize("model", ["sd15", "sdxl"])
def test_build_model_is_the_full_width_model_in_bf16(model: str) -> None:
    sd = txt2img.build_model(model, 3, "meta")
    assert type(sd) is (StableDiffusion_XL if model == "sdxl" else StableDiffusion_1)
    assert sd.unet.dtype == sd.lda.dtype == torch.bfloat16 and sd.unet.device.type == "meta"
    assert isinstance(sd.solver, DDIM) and len(sd.steps) == 3
    assert sd.unet.param_count() == (2_567_463_684 if model == "sdxl" else 859_520_964)


@pytest.mark.parametrize("model", ["sd15", "sdxl"])
def test_txt2img_equals_text_to_image(model: str, weights_dir: Path, built: list[Any], tmp_path: Path) -> None:
    out = tmp_path / "out.png"
    image = txt2img.main([
        "--model", model, "--prompt", PROMPT, "--weights-dir", str(weights_dir), "--steps", str(STEPS),
        "--size", str(SIZE), "--seed", str(SEED), "--out", str(out), "--device", "cpu",
    ])  # fmt: skip
    assert len(built) == 1 and built[0].unet.dtype == torch.bfloat16
    want = TextToImage(_loaded(model, weights_dir), size=(SIZE, SIZE))(PROMPT, negative_prompt="low quality, blurry", seed=SEED)
    assert image.size == (SIZE, SIZE) and np.ptp(np.asarray(image)) > 0
    np.testing.assert_array_equal(np.asarray(image), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(Image.open(out)), np.asarray(want))


def _controlnet_lora_reference(weights_dir: Path, lora: bool) -> Any:
    """The example's request without a mesh: the same files, adapters and seed."""
    sd = _loaded("sd15", weights_dir)
    if lora:
        SDLoraManager(sd).add_loras("style", tensors=load_from_safetensors(weights_dir / "lora.safetensors"), scale=0.7)
    adapter = SD1ControlnetAdapter(
        sd.unet, name="canny", scale=0.8, weights=load_from_safetensors(weights_dir / "controlnet.sd15.canny.safetensors")
    ).inject()  # fmt: skip
    condition = image_to_tensor(Image.open(weights_dir / "canny.png").convert("RGB"))
    adapter.set_controlnet_condition(torch.cat([condition, condition]))
    return TextToImage(sd, size=(SIZE, SIZE), condition_scale=7.5)(PROMPT, negative_prompt="low quality", seed=SEED)


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "no_lora"])
def test_controlnet_lora_equals_text_to_image(lora: bool, weights_dir: Path, built: list[Any], tmp_path: Path) -> None:
    """The image equals the request without a mesh; the model was placed on
    a (1, 1) mesh; the process group the example started is ended; the
    ControlNet is at the reduced UNet's widths and the LoRA on every
    transformer Linear of the UNet and CLIP."""
    import torch.distributed as dist

    args = ["--weights-dir", str(weights_dir), "--condition", str(weights_dir / "canny.png"), "--prompt", PROMPT,
            "--steps", str(STEPS), "--seed", str(SEED), "--out", str(tmp_path / "out.png"), "--device", "cpu"]  # fmt: skip
    if lora:
        args += ["--lora", str(weights_dir / "lora.safetensors")]
    image = controlnet_lora.main(args)
    (sd,) = built
    assert tuple(sd.mesh.shape) == (1, 1) and sd.mesh.mesh_dim_names == ("data", "tensor") and not dist.is_initialized()
    assert sd.unet.ensure_find(Controlnet).name == "canny"
    want = _controlnet_lora_reference(weights_dir, lora)
    assert image.size == (SIZE, SIZE)
    np.testing.assert_array_equal(np.asarray(image), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out.png")), np.asarray(want))
    if lora:
        without = _controlnet_lora_reference(weights_dir, lora=False)
        assert not np.array_equal(np.asarray(without), np.asarray(want))


def test_a_lora_added_after_the_controlnet_fails_the_sanity_check(weights_dir: Path) -> None:
    """Why the example adds its LoRA before its ControlNet (the JAX example
    adds it after): the ControlNet's copy of the UNet's encoder comes first
    in the UNet, so the LoRA's encoder keys attach there, then again to the
    UNet's own layers in the sanity check's second pass. The JAX package's
    `auto_attach_loras` has the same two passes."""
    sd = _loaded("sd15", weights_dir)
    SD1ControlnetAdapter(
        sd.unet, name="canny", weights=load_from_safetensors(weights_dir / "controlnet.sd15.canny.safetensors")
    ).inject()  # fmt: skip
    with pytest.raises(ValueError, match="attached twice"):
        SDLoraManager(sd).add_loras("style", tensors=load_from_safetensors(weights_dir / "lora.safetensors"))
