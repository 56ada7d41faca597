"""SD1.5 with a ControlNet and a LoRA stacked, data-parallel over a mesh.

    python -m refiners_tpu_torch.examples.controlnet_lora --weights-dir ~/weights \
        --condition canny.png --lora pixel_art.safetensors --prompt "..."
    torchrun --nproc-per-node=2 -m refiners_tpu_torch.examples.controlnet_lora ...

The port's counterpart of ``examples/controlnet_lora.py``, with its
arguments and ``--device`` (``cpu`` to run without the card): the port's
`StableDiffusion_1` in bfloat16 with DDIM (``sd15.*`` files, as
`txt2img`), a ControlNet named "canny" at 0.8 from
``controlnet.sd15.canny.safetensors``, an optional LoRA at 0.7 through
`SDLoraManager` (added before the ControlNet, where the JAX example adds
it after), the condition image doubled for the CFG pair. The image
out has the condition's size (a 512² condition, as the JAX example takes,
gives a 512² image). The model is placed on `make_mesh()` by
`TextToImage(mesh=...)` (`shard_latent_diffusion`), so the CFG pair splits
over the mesh's "data" axis. Under ``torchrun`` every process takes its card and the first saves
the image; run alone, the example starts a process group of one itself
(NCCL on the card, gloo with ``--device cpu``) and ends it after.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
from pathlib import Path
from typing import Any, Iterator


@contextlib.contextmanager
def process_group(device: str) -> Iterator[None]:
    """The running process group, the one ``torchrun`` describes in the
    environment, or else a world of one over a file store in a temporary
    directory, ended on exit."""
    import os

    import torch.distributed as dist

    from refiners_tpu_torch.parallel import init_process_group

    backend = "gloo" if device == "cpu" else "nccl"
    if dist.is_initialized():
        yield
    elif "RANK" in os.environ:
        init_process_group(backend)
        yield
    else:
        with tempfile.TemporaryDirectory(prefix="controlnet_lora_") as store:
            init_process_group(backend, init_method=f"file://{store}/store", rank=0, world_size=1)
            try:
                yield
            finally:
                dist.destroy_process_group()


def main(argv: list[str] | None = None) -> Any:
    """Serve one request and save its image (the first rank); returns the image."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights-dir", type=Path, required=True)
    p.add_argument("--condition", type=Path, required=True)
    p.add_argument("--lora", type=Path, default=None)
    p.add_argument("--prompt", required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=Path, default=Path("output.png"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist
    from PIL import Image

    from refiners_tpu_torch.examples import txt2img
    from refiners_tpu_torch.fluxion.utils import image_to_tensor, load_from_safetensors
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1ControlnetAdapter, SDLoraManager
    from refiners_tpu_torch.parallel import make_mesh
    from refiners_tpu_torch.pipelines import TextToImage

    with process_group(args.device):
        device = args.device if args.device == "cpu" else f"cuda:{torch.cuda.current_device()}"
        sd = txt2img.build_model("sd15", args.steps, device)
        txt2img.load_weights(sd, args.weights_dir, "sd15")
        # the LoRA first: added after the ControlNet, its keys would attach to the ControlNet's copy of
        # the UNet's encoder first and fail `auto_attach_loras`'s sanity check
        if args.lora is not None:
            SDLoraManager(sd).add_loras("style", tensors=load_from_safetensors(args.lora), scale=0.7)
        controlnet = SD1ControlnetAdapter(
            sd.unet,
            name="canny",
            scale=0.8,
            weights=load_from_safetensors(args.weights_dir / "controlnet.sd15.canny.safetensors"),
        ).inject()

        condition_image = Image.open(args.condition).convert("RGB")
        condition = image_to_tensor(condition_image, device=device)
        controlnet.set_controlnet_condition(torch.cat([condition, condition]))

        # data-parallel over the mesh: the CFG pair splits across its "data" axis at each step
        mesh = make_mesh(device_type="cpu" if args.device == "cpu" else "cuda")
        pipe = TextToImage(sd, size=(condition_image.height, condition_image.width), condition_scale=7.5, mesh=mesh)
        image = pipe(args.prompt, negative_prompt="low quality", seed=args.seed)
        if dist.get_rank() == 0:
            image.save(args.out)
            print(f"saved {args.out}")
    return image


if __name__ == "__main__":
    main()
