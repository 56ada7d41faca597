"""Text-to-image with SD1.5 or SDXL, on one NVIDIA card.

    python -m refiners_tpu_torch.examples.txt2img --model sdxl --prompt "a lighthouse at dawn" \
        --weights-dir ~/weights --steps 30 --size 1024

The port's counterpart of ``examples/txt2img.py``, with its arguments and
``--device`` (``cpu`` to run without the card). The model is the port's
`StableDiffusion_1` or `StableDiffusion_XL` in bfloat16 with DDIM, served
through `TextToImage`. Its weights are refiners-layout safetensors in the
port's layouts (``python -m refiners_tpu_torch.conversion.cli`` converts
diffusers / LDM / transformers files): ``<stem>.safetensors`` under
``--weights-dir`` for the UNet, the VAE and the text encoder (``sd15.unet``,
``sd15.autoencoder``, ``sd15.text_encoder``, or the ``sdxl.`` ones), loaded
strictly.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

# the file stems of each model's parts, as the JAX package's example reads them
STEMS = {
    "sd15": {"unet": "sd15.unet", "lda": "sd15.autoencoder", "clip_text_encoder": "sd15.text_encoder"},
    "sdxl": {"unet": "sdxl.unet", "lda": "sdxl.autoencoder", "clip_text_encoder": "sdxl.text_encoder"},
}


def build_model(model: str, steps: int, device: str) -> Any:
    """The full-width model in bfloat16 on `device`, with DDIM at `steps`."""
    import torch

    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_1, StableDiffusion_XL

    facade = StableDiffusion_XL if model == "sdxl" else StableDiffusion_1
    return facade(solver=DDIM(num_inference_steps=steps, device=device), device=device, dtype=torch.bfloat16)


def load_weights(sd: Any, weights_dir: Path, model: str) -> None:
    """Each part of `sd` from ``weights_dir/<stem>.safetensors``, strictly."""
    for attr, stem in STEMS[model].items():
        getattr(sd, attr).load_from_safetensors(weights_dir / f"{stem}.safetensors", strict=True)


def main(argv: list[str] | None = None) -> Any:
    """Serve one request and save its image; returns the image."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["sd15", "sdxl"], default="sd15")
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative", default="low quality, blurry")
    p.add_argument("--weights-dir", type=Path, required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--out", type=Path, default=Path("output.png"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from refiners_tpu_torch.pipelines import TextToImage

    sd = build_model(args.model, args.steps, args.device)
    load_weights(sd, args.weights_dir, args.model)
    size = args.size or (1024 if args.model == "sdxl" else 512)
    pipe = TextToImage(sd, size=(size, size), condition_scale=args.scale)
    image = pipe(args.prompt, negative_prompt=args.negative, seed=args.seed)
    image.save(args.out)
    print(f"saved {args.out}")
    return image


if __name__ == "__main__":
    main()
