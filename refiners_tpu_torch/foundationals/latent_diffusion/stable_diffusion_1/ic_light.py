"""IC-Light: relighting with a patched SD1.5 that reads the latents of a
condition image beside its own; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_1/ic_light.py``.

The UNet's input conv is widened to 8 channels (the 4 new ones zero), then
the patch's deltas are added onto every weight of the UNet. The patch is a
state dict in the port's (torch) layout: the conv's weight is OIHW, its
input channels on axis 1.
"""

from __future__ import annotations

from typing import Any

import torch
from PIL import Image

from refiners_tpu_torch.fluxion import layers as fl
from refiners_tpu_torch.foundationals.clip.text_encoder import CLIPTextEncoderL
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import Solver
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.model import SD1Autoencoder, StableDiffusion_1
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import DownBlocks, SD1UNet


class ICLight(StableDiffusion_1):
    """Text-conditioned relighting model; builds on the card unless `device`
    says otherwise."""

    def __init__(
        self,
        patch_weights: dict[str, torch.Tensor],
        unet: SD1UNet,
        lda: SD1Autoencoder | None = None,
        clip_text_encoder: CLIPTextEncoderL | None = None,
        solver: Solver | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            unet=unet, lda=lda, clip_text_encoder=clip_text_encoder, solver=solver, device=device, dtype=dtype
        )
        self._ic_light_condition: torch.Tensor | None = None
        self._extend_conv_in()
        self._apply_patch(weights=patch_weights)

    def _extend_conv_in(self) -> None:
        """Widen the UNet's input conv to 4 more input channels, their weights zero."""
        first_block = self.unet.ensure_find(DownBlocks).layer(0, fl.Chain)
        conv_in = first_block.ensure_find(fl.Conv2d)
        new_conv_in = fl.Conv2d(
            in_channels=conv_in.in_channels + 4,
            out_channels=conv_in.out_channels,
            kernel_size=conv_in.kernel_size,
            padding=conv_in.padding,
            device=conv_in.device,
            dtype=conv_in.dtype,
        )
        with torch.no_grad():
            new_conv_in.weight.zero_()
            new_conv_in.weight[:, :4].copy_(conv_in.weight)  # OIHW: input channels on axis 1
            new_conv_in.bias.copy_(conv_in.bias)
        first_block.replace(old_module=conv_in, new_module=new_conv_in)

    def _apply_patch(self, weights: dict[str, torch.Tensor]) -> None:
        """Add the patch's deltas onto the UNet's weights."""
        current = self.unet.state_dict()
        new_state_dict = {
            key: tensor + weights[key].to(device=tensor.device, dtype=tensor.dtype) for key, tensor in current.items()
        }
        self.unet.load_state_dict(new_state_dict)

    @staticmethod
    def compute_gray_composite(image: Image.Image, mask: Image.Image) -> Image.Image:
        """`image` composited onto the 127-gray background IC-Light expects."""
        assert mask.mode == "L", "Mask must be a grayscale image"
        assert image.size == mask.size, "Image and mask must have the same size"
        background = Image.new("RGB", image.size, (127, 127, 127))
        return Image.composite(image, background, mask)

    def set_ic_light_condition(self, image: Image.Image, mask: Image.Image | None = None) -> None:
        if mask is not None:
            image = self.compute_gray_composite(image=image, mask=mask)
        self._ic_light_condition = self.lda.image_to_latents(image)

    def predict_noise(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 2.0,
        **_: Any,
    ) -> torch.Tensor:
        assert self._ic_light_condition is not None, "Reference image not set, use `set_ic_light_condition` first"
        # the condition's latents join the latents on the channel axis at every step
        x = torch.cat((x[:, :4], self._ic_light_condition.to(x.dtype)), dim=1)
        return super().predict_noise(x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale)

    def forward(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 2.0,
        **kwargs: Any,
    ) -> torch.Tensor:
        return super().forward(
            x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
        )
