from refiners_tpu_torch.foundationals.swin.mvanet.mvanet import MVANet

__all__ = ["MVANet"]
