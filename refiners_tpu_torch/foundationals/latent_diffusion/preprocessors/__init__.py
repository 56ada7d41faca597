from refiners_tpu_torch.foundationals.latent_diffusion.preprocessors.informative_drawings import InformativeDrawings

__all__ = ["InformativeDrawings"]
