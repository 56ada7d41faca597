from refiners_tpu_torch.fluxion.rng import manual_seed

__all__ = ["manual_seed"]
