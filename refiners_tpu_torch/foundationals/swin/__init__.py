from refiners_tpu_torch.foundationals.swin.swin_transformer import SwinTransformer

__all__ = ["SwinTransformer"]
