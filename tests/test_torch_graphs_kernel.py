"""The port's compiled programs (`refiners_tpu_torch.fluxion.graphs`) on the
card: each program's replays against the same function run eagerly.

- a reduced SD1.5 (`SD1UNet(base_channels=64)`: heads of d = 8, the
  kernels' least; a 2-layer CLIP-L, the full VAE) at 256², bf16, through
  `TextToImage`: the loop and the decode
  replayed bit-equal to the eager functions, the K1 launches of a replay
  equal to the eager call's, two seeds two images (DPM++ SDE: the solver
  draws inside the loop) each equal to its eager image, and a replay after
  each edit of the CPU key test (`tests/test_torch_graphs.py`: a LoRA
  injected, its scale, ejected, the guidance scale, a ControlNet and a new
  condition, an in-place ``load_state_dict``) equal to eager;
- a reduced SDXL (`SDXLUNet(base_channels=32)`, full text encoders and
  VAE) at 512², bf16: loop and decode bit-equal;
- SAM (`SAMViT(embedding_dim=64, num_layers=2, num_heads=4)` at 1024²,
  HQ-SAM injected): the embedding and `predict` bit-equal;
- 4 steps of the SD1.5 training example (`SD1UNet(base_channels=64)`,
  32² latents, AdamW) under ``jit_step``: losses and weights bit-equal to
  the eager trainer's, K2 / K4a / K4b launches equal;
- a capture that reads back to the host raises, naming the operation, and
  the card works after it; so does a call that changes its own key; a
  replay neither reads nor returns the caller's tensors.

They need an NVIDIA card with nvcc (sm_90a) and skip elsewhere. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_kernel.py -q
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import graphs, manual_seed
from refiners_tpu_torch.fluxion.utils import synthesize_weights
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DPMSolver,
    SD1Autoencoder,
    SD1ControlnetAdapter,
    SD1UNet,
    SDXLUNet,
    StableDiffusion_1,
    StableDiffusion_XL,
)
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import SolverParams
from refiners_tpu_torch.pipelines import TextToImage, _diffuse

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _launches() -> dict[str, int]:
    return {c.__name__: c.launches for c in graphs._counters()}


def _reset() -> None:
    for c in graphs._counters():
        c.launches = 0


@pytest.fixture(scope="module")
def sd15(device: torch.device) -> StableDiffusion_1:
    sd = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=64, device=device),
        lda=SD1Autoencoder(device=device),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12, device=device),
        solver=DDIM(num_inference_steps=10, device=device),
        device=device,
        dtype=BF16,
    )
    synthesize_weights(sd, seed=1)
    return sd


def _inputs(sd: Any, device: torch.device, seed: int, size: int, dim: int = 768) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((1, 4, size // 8, size // 8), generator=gen, device=device).to(BF16)
    return x, torch.randn((2, 77, dim), generator=gen, device=device).to(BF16)


def _eager_and_replays(program: graphs.Program, *args: Any, **kwargs: Any) -> tuple[Any, list[Any]]:
    """The function run eagerly, then the program called three times (its
    first call eager and captured, then two replays)."""
    with torch.inference_mode():
        eager = program.fn(*args, **kwargs)
        outputs = [program(*args, **kwargs) for _ in range(3)]
    return eager, outputs[1:]


def test_the_sd15_loop_and_decode_replay_the_eager_calls(sd15: StableDiffusion_1, device: torch.device) -> None:
    """Bit-equal replays, K1's launches of a replay those of the eager
    call, one capture for three calls, a replay's output a fresh tensor."""
    pipe = TextToImage(sd15, size=(256, 256))
    diffuse, decode = pipe._program("diffuse", _diffuse), pipe._program("decode", pipe._decode)
    x, emb = _inputs(sd15, device, 0, 256)
    gen = torch.Generator(device)
    _reset()
    with torch.inference_mode():
        sd15.diffuse(x, clip_text_embedding=emb, condition_scale=7.5, generator=gen)
    eager_launches = _launches()
    assert eager_launches["flash_attention_packed"] == 5 * 10  # 2 + 3 sites at 32² latents, CFG in one call
    eager, replays = _eager_and_replays(diffuse, sd15, x, emb, 7.5, gen)
    for z in replays:
        assert torch.equal(z, eager)
    assert replays[0] is not replays[1] and diffuse.captures == 1
    _reset()
    with torch.inference_mode():
        diffuse(sd15, x, emb, 7.5, gen)
    assert _launches() == eager_launches
    eager_image, images = _eager_and_replays(decode, sd15.lda, eager)
    for image in images:
        assert torch.equal(image, eager_image)


def test_two_seeds_give_two_images_each_its_eager_image(sd15: StableDiffusion_1, device: torch.device) -> None:
    """DPM++ SDE draws inside the loop from the pipeline's generator,
    registered with the graph and seeded again at each request."""
    sd15.solver = DPMSolver(10, params=SolverParams(sde_variance=1.0), device=device)
    try:
        pipe = TextToImage(sd15, size=(256, 256))
        pipe("a cat", seed=1)  # captures

        def eager(seed: int) -> np.ndarray:
            gen = torch.Generator(device).manual_seed(seed)
            with torch.inference_mode():
                noise = torch.randn((1, 4, 32, 32), generator=gen, device=device, dtype=torch.float32)
                x = sd15.solver.scale_model_input(noise.to(BF16), step=-1)
                emb = sd15.compute_clip_text_embedding("a cat", "")
                z = sd15.diffuse(x, clip_text_embedding=emb, condition_scale=7.5, generator=gen)
                return np.asarray(_to_image(sd15.lda.decode(z)))

        images = {seed: np.asarray(pipe("a cat", seed=seed)) for seed in (1, 2)}
        assert pipe._compiled["diffuse"].captures == 1
        assert not np.array_equal(images[1], images[2])
        for seed, image in images.items():
            np.testing.assert_array_equal(image, eager(seed))
    finally:
        sd15.solver = DDIM(10, device=device)


def _to_image(decoded: torch.Tensor) -> Image.Image:
    from refiners_tpu_torch.fluxion.utils import tensor_to_images

    return tensor_to_images((decoded + 1) / 2)[0]


def _lora(sd: StableDiffusion_1, seed: int) -> dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    linears = [l for b in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in b.layers(fl.Linear, recurse=True)]
    weights: dict[str, torch.Tensor] = {}
    for n, linear in enumerate(linears):
        weights[f"lora_unet_{n:04d}.lora_down.weight"] = torch.randn(8, linear.in_features, generator=gen) * 0.05
        weights[f"lora_unet_{n:04d}.lora_up.weight"] = torch.randn(linear.out_features, 8, generator=gen) * 0.05
    return weights


def test_a_replay_after_each_edit_equals_eager(sd15: StableDiffusion_1, device: torch.device) -> None:
    """The CPU key test's edits, each followed by the program called until
    it replays: its result bit-equal to the eager loop's."""
    program = TextToImage(sd15, size=(256, 256))._program("diffuse", _diffuse)
    x, emb = _inputs(sd15, device, 3, 256)
    gen = torch.Generator(device)

    def check(label: str, scale: float = 7.5) -> None:
        eager, replays = _eager_and_replays(program, sd15, x, emb, scale, gen)
        assert all(torch.equal(z, eager) for z in replays), label

    check("bare")
    manager = SDLoraManager(sd15)
    manager.add_loras("style", {k: v.to(device, BF16) for k, v in _lora(sd15, 4).items()}, scale=0.8,
                      unet_inclusions=["CrossAttentionBlock"])  # fmt: skip
    check("LoRA injected")
    manager.set_scale("style", 0.5)
    check("its scale changed")
    manager.remove_loras("style")
    check("LoRA ejected")
    check("condition_scale", scale=5.0)
    controlnet = SD1ControlnetAdapter(sd15.unet, name="canny").inject()
    synthesize_weights(controlnet, seed=5)
    gen_c = torch.Generator(device).manual_seed(6)
    controlnet.set_controlnet_condition(torch.rand((1, 3, 256, 256), generator=gen_c, device=device))
    check("a ControlNet")
    captures = program.captures
    controlnet.set_controlnet_condition(torch.rand((1, 3, 256, 256), generator=gen_c, device=device))
    check("a new condition of the same shape")
    assert program.captures == captures  # the condition is an input, not a new program
    controlnet.eject()
    sd15.unet.load_state_dict({k: v * 1.01 for k, v in sd15.unet.state_dict().items()})
    check("load_state_dict in place")


def test_the_sdxl_loop_and_decode_replay_the_eager_calls(device: torch.device) -> None:
    sd = StableDiffusion_XL(unet=SDXLUNet(in_channels=4, base_channels=32, device=device), solver=DDIM(5, device=device),
                            device=device, dtype=BF16)  # fmt: skip
    synthesize_weights(sd, seed=7)
    pipe = TextToImage(sd, size=(512, 512))
    gen = torch.Generator(device).manual_seed(8)
    x = torch.randn((1, 4, 64, 64), generator=gen, device=device).to(BF16)
    emb = torch.randn((2, 77, 2048), generator=gen, device=device).to(BF16)
    pooled = torch.randn((2, 1280), generator=gen, device=device).to(BF16)
    kwargs = {"pooled_text_embedding": pooled, "time_ids": sd.default_time_ids}  # (2, 6): the CFG pair
    eager, replays = _eager_and_replays(pipe._program("diffuse", _diffuse), sd, x, emb, 5.0, gen, **kwargs)
    assert all(torch.equal(z, eager) for z in replays)
    eager_image, images = _eager_and_replays(pipe._program("decode", pipe._decode), sd.lda, eager)
    assert all(torch.equal(image, eager_image) for image in images)
    with torch.inference_mode():
        assert isinstance(pipe("a cat", seed=0), Image.Image)


def test_sam_programs_replay_the_eager_calls(device: torch.device) -> None:
    """The embedding and `predict` (points, then a box), HQ-SAM injected so
    that the encoder's captured context crosses from one program to the
    other."""
    from refiners_tpu_torch.foundationals.segment_anything import model as sam_model
    from refiners_tpu_torch.foundationals.segment_anything.hq_sam import HQSAMAdapter
    from refiners_tpu_torch.foundationals.segment_anything.image_encoder import SAMViT
    from refiners_tpu_torch.foundationals.segment_anything.mask_decoder import MaskDecoder
    from refiners_tpu_torch.foundationals.segment_anything.prompt_encoder import MaskEncoder, PointEncoder

    sam = sam_model.SegmentAnything(
        SAMViT(embedding_dim=64, num_layers=2, num_heads=4, global_attention_indices=(1,)),
        PointEncoder(), MaskEncoder(), MaskDecoder(multimask_output=False), device=device,
    )  # fmt: skip
    HQSAMAdapter(sam).inject()
    synthesize_weights(sam_model._root_chain(sam), seed=9)
    image = Image.fromarray(np.random.RandomState(10).randint(0, 255, (600, 800, 3), dtype=np.uint8))
    canvas, scaled = sam._host_preprocess(image)
    root = sam_model._root_chain(sam)
    eager, replays = _eager_and_replays(sam_model._encode_image, root, canvas, scaled)
    for features, captured in replays:
        assert torch.equal(features, eager[0]) and captured.keys() == eager[1].keys()
        assert torch.equal(captured["hq_sam"]["early_vit_embedding"], eager[1]["hq_sam"]["early_vit_embedding"])
    with torch.inference_mode():
        embedding = sam.compute_image_embedding(image)
    for prompt in ({"foreground_points": ((100.0, 200.0), (300.0, 250.0)), "background_points": ((50.0, 50.0),)},
                   {"box_points": [[(100.0, 100.0), (500.0, 400.0)]]}):  # fmt: skip
        with torch.inference_mode():
            calls = [sam.predict(embedding, **prompt) for _ in range(3)]
            coordinates, type_mask = sam.point_encoder.points_to_tensor(**prompt)
            eager_masks = sam_model._predict_masks.fn(
                root, embedding.features, coordinates.to(device), tuple(map(tuple, type_mask.tolist())), None,
                embedding.captured_contexts, embedding.original_image_size, sam.image_encoder_resolution, True,
            )  # fmt: skip
        for masks, iou, low in calls[1:]:
            assert torch.equal(masks, eager_masks[0]) and torch.equal(iou, eager_masks[1]) and torch.equal(low, eager_masks[2])
    sam_model._encode_image.clear_cache()
    sam_model._predict_masks.clear_cache()


def test_four_jit_step_steps_equal_the_eager_steps(device: torch.device) -> None:
    """The SD1.5 training example, reduced, bf16, 4 steps with gradient
    accumulation 2, cuDNN deterministic, with and without ``jit_step``."""
    from refiners_tpu_torch.examples.train_unet import CONFIG, UnetConfig, UnetTrainer

    def run(jit_step: bool) -> tuple[list[float], dict[str, torch.Tensor], dict[str, int]]:
        manual_seed(0)  # the UNet's biases and norms come from the init stream
        toml = CONFIG.replace('"100:step"', '"4:step"').replace("[training]", f"[training]\njit_step = {str(jit_step).lower()}")
        trainer = UnetTrainer(UnetConfig.load_from_toml_string(toml), base_channels=64, batch_size=2, latent_size=32, num_batches=4)
        losses: list[float] = []
        step = trainer.step

        def recorded(batch: Any) -> None:
            step(batch)
            losses.append(float(trainer.loss))

        trainer.step = recorded  # type: ignore[method-assign]
        _reset()
        trainer.train()
        return losses, {k: v.detach().clone() for k, v in trainer.unet.state_dict().items()}, _launches()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager_losses, eager_weights, eager_launches = run(False)
        losses, weights, launches = run(True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert len(losses) == 4 and losses == eager_losses
    assert all(torch.equal(weights[k], v) for k, v in eager_weights.items())
    assert launches == eager_launches and launches["flash_attention_bwd_dq"] > 0


def test_a_capture_that_reads_back_raises_naming_the_operation(device: torch.device) -> None:
    layer = fl.Linear(8, 8, device=device)
    program = graphs.Program(lambda m, x: m(x) * float(x.sum()), name="reads back")
    x = torch.randn(4, 8, device=device)
    with pytest.raises(graphs.CaptureError, match="reads back.*float"):
        with torch.inference_mode():
            program(layer, x)
    assert torch.isfinite(layer(x)).all()  # the card works after it


def test_a_call_that_changes_its_own_key_raises_naming_it(device: torch.device) -> None:
    """A call that sets a plain attribute of its model at each run could
    never be replayed: it raises, naming the attribute, and caches nothing."""
    layer = fl.Linear(8, 8, device=device)
    layer.calls = 0

    def counted(m: fl.Linear, x: torch.Tensor) -> torch.Tensor:
        m.calls += 1
        return m(x)

    program = graphs.Program(counted, name="counts its calls")
    with pytest.raises(graphs.CaptureError, match=r"counts its calls: a call changes its own key.*in Linear.*'calls'"):
        with torch.inference_mode():
            program(layer, torch.randn(4, 8, device=device))
    assert program.captures == 0 and not program._cache


def test_a_replay_owns_its_inputs_and_outputs(device: torch.device) -> None:
    layer = fl.Linear(8, 8, device=device)
    program = graphs.Program(lambda m, x: m(x))
    x = torch.randn(4, 8, device=device)
    with torch.inference_mode():
        first, second = program(layer, x), program(layer, x)
        y = x.clone()
        third = program(layer, y)
        y.add_(1.0)  # the caller's tensor changes after the call: the result does not
        assert torch.equal(third, second) and torch.equal(second, first)
        fourth = program(layer, y)
        assert torch.equal(fourth, layer(y)) and not torch.equal(fourth, third)
