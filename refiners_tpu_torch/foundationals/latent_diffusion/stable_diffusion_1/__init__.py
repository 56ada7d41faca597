from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet

__all__ = ["SD1UNet"]
