"""The plain reference against the port, on the CPU, before it judges the
card: its keys and shapes are the port's at the published widths, and at
reduced widths, on identical weights, it computes what the port computes
(text encoders, U-Net, DDIM under CFG, the decoder, LoRAs, and the first
fine-tuning steps through the port's `Trainer`).

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import pytest
import torch

from h100_bench import bench, models
from h100_bench.reference import clip, unet, vae
from h100_bench.reference.diffusion import model_spec
from h100_bench.reference.nn import Ops, Weights
from h100_bench.reference.tokenizer import Tokenizer
from h100_bench.tests import tiny
from h100_bench.weights import make

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def checkout() -> Path:
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.copy_bench(Path(tmp))


@pytest.mark.parametrize("config", ["sd15", "sdxl-base-1.0"])
def test_keys_and_shapes_are_the_ports(config: str) -> None:
    cfg = bench.load_json(bench.BENCH / "configs" / f"{config}.json")
    sd = models.latent_diffusion(cfg, "meta", torch.bfloat16)
    port = {f"{part}.{k}": tuple(v.shape) for part, m in models.parts(sd).items() for k, v in m.state_dict().items()}
    assert model_spec(cfg) == port


def test_tokenizer_is_the_ports() -> None:
    from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer

    cell = bench.Cell.load("sdxl-1024-b1", bench.load_json(bench.ROOT / "BENCHMARK.json"))
    texts = [t for group in cell.driver().prompts(cell) for t in group] + [""]
    ours, port_l, port_g = Tokenizer(), CLIPTokenizer(), CLIPTokenizer(pad_token_id=0)
    for text in texts:
        assert ours(text) == port_l(text)[0].tolist()
        assert ours(text, pad=0) == port_g(text)[0].tolist()


@pytest.mark.parametrize("name", ["tiny-sd15", "tiny-sdxl"])
def test_parts_match_the_port(name: str) -> None:
    cfg = tiny.tiny_config(name)
    weights = make(model_spec(cfg), 5, CPU, torch.float32)
    sd = models.latent_diffusion(cfg, CPU, torch.float32)
    models.load(models.parts(sd), weights)
    W = {part: Weights({k[len(part) + 1 :]: v for k, v in weights.items() if k.startswith(f"{part}.")})
         for part in ("unet", "text", "vae")}  # fmt: skip
    ops = Ops()
    prompt = ["a red fox in the snow, high detail"]
    tokens = torch.tensor([Tokenizer()(prompt[0])])
    with torch.no_grad():
        if cfg["family"] == "sd1":
            ctx, pooled, time_ids = clip.clip_l(W["text"], ops, tokens, cfg["text_encoder"]), None, None
            port_ctx = sd.clip_text_encoder(prompt)
            torch.testing.assert_close(ctx, port_ctx, rtol=1e-4, atol=1e-4)
        else:
            tokens_g = torch.tensor([Tokenizer()(prompt[0], pad=0)])
            ctx, pooled = clip.sdxl_text(W["text"], ops, tokens, tokens_g, cfg["text_encoder"], cfg["text_encoder_2"])
            port_ctx, port_pooled = sd.clip_text_encoder(prompt)
            torch.testing.assert_close(ctx, port_ctx, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(pooled, port_pooled, rtol=1e-4, atol=1e-4)
            time_ids = torch.tensor([cfg["time_ids"]], dtype=torch.float32)
            sd.unet.set_pooled_text_embedding(pooled)
            sd.unet.set_time_ids(time_ids)
        x = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(0))
        t = torch.tensor([421])
        sd.unet.set_timestep(t)
        sd.unet.set_clip_text_embedding(ctx)
        ours = unet.UNet(cfg["unet"], cfg["family"])(W["unet"], ops, x, t.float(), ctx, pooled, time_ids)
        torch.testing.assert_close(ours, sd.unet(x), rtol=1e-4, atol=1e-4)
        z = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(vae.decode(W["vae"], ops, z, cfg["vae"]["scaling_factor"]), sd.lda.decode(z),
                                   rtol=1e-4, atol=1e-4)  # fmt: skip


@pytest.mark.parametrize("cell", ["tiny-sd15-b1", "tiny-sdxl-b1", "tiny-sdxl-lora2", "tiny-sd15-train"])
def test_cells_agree_in_float32(checkout: Path, cell: str) -> None:
    """A whole run of a tiny float32 cell on the CPU: the program's outputs
    (served images and latents, or the first fine-tuning steps) agree with
    the reference's to float32 rounding (images to their 8 bits)."""
    result = bench.run_cell(tiny.cell(checkout, cell), 2**33 + 3, 0.5, False, CPU, 0.0)
    assert result["correct"], result["check"]
    for name, number in result["check"].items():
        assert number["value"] < number["limit"], name
