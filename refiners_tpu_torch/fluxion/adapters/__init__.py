from refiners_tpu_torch.fluxion.adapters.adapter import Adapter

__all__ = ["Adapter"]
