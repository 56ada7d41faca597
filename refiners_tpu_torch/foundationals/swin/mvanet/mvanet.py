"""MVANet, the multi-view aggregation network (arXiv:2404.07445); counterpart
of ``refiners_tpu/foundationals/swin/mvanet/mvanet.py``.

NCHW; multi-view stacks are (B, 5, C, H, W): four tiles and the downscaled
whole view. Batch 1 (MCLM and MCRM squeeze it), input 1024² (MCLM's 16 × 16
grid).
"""

from __future__ import annotations

from typing import Any

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.swin.swin_transformer import SwinTransformer

from refiners_tpu_torch.foundationals.swin.mvanet.mclm import MCLM
from refiners_tpu_torch.foundationals.swin.mvanet.mcrm import MCRM
from refiners_tpu_torch.foundationals.swin.mvanet.utils import (
    BatchNorm2d,
    Interpolate,
    PatchMerge,
    PatchSplit,
    PReLU,
    Rescale,
    Unflatten,
)


class CBG(fl.Chain):
    """(C)onvolution + (B)atchNorm + (G)eLU."""

    def __init__(self, in_dim: int, out_dim: int | None = None, device: Any = None) -> None:
        out_dim = out_dim or in_dim
        super().__init__(
            fl.Conv2d(in_dim, out_dim, kernel_size=3, padding=1, device=device),
            BatchNorm2d(out_dim, device=device),
            fl.GeLU(),
        )


class CBR(fl.Chain):
    """(C)onvolution + (B)atchNorm + Parametric (R)eLU."""

    def __init__(self, in_dim: int, out_dim: int | None = None, device: Any = None) -> None:
        out_dim = out_dim or in_dim
        super().__init__(
            fl.Conv2d(in_dim, out_dim, kernel_size=3, padding=1, device=device),
            BatchNorm2d(out_dim, device=device),
            PReLU(device=device),
        )


class SplitMultiView(fl.Chain):
    """(b, c, H, W) → (b, 5, c, H/2, W/2): 4 tiles + 1 downscaled global view."""

    def __init__(self) -> None:
        super().__init__(
            fl.Concatenate(
                PatchSplit(),  # local tiles
                fl.Chain(  # global view
                    Rescale(scale_factor=0.5, mode="bilinear"),
                    fl.Unsqueeze(1),
                ),
                dim=1,
            )
        )


class ShallowUpscaler(fl.Chain):
    """4× upscaler reusing shallow image features (SwinIR-style)."""

    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.Sum(
                fl.Identity(),
                fl.Chain(
                    fl.UseContext("mvanet", "shallow"),
                    Interpolate((256, 256)),
                ),
            ),
            fl.Sum(
                fl.Chain(
                    Rescale(2),
                    CBG(embedding_dim, device=device),
                ),
                fl.Chain(
                    fl.UseContext("mvanet", "shallow"),
                    Interpolate((512, 512)),
                ),
            ),
            Rescale(2),
            CBG(embedding_dim, device=device),
        )


class PyramidL5(fl.Chain):
    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.GetArg(0),  # output5
            fl.Flatten(0, 1),
            CBR(1024, embedding_dim, device=device),
            Unflatten(0, (-1, 5)),
            MCLM(embedding_dim, device=device),
            fl.Flatten(0, 1),
            Interpolate((32, 32)),
        )


class PyramidL4(fl.Chain):
    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.Sum(
                PyramidL5(embedding_dim=embedding_dim, device=device),
                fl.Chain(
                    fl.GetArg(1),
                    fl.Flatten(0, 1),
                    CBR(512, embedding_dim, device=device),  # output4
                    Unflatten(0, (-1, 5)),
                ),
            ),
            MCRM(embedding_dim, 32, device=device),  # dec_blk4
            fl.Flatten(0, 1),
            CBR(embedding_dim, device=device),  # conv4
            Interpolate((64, 64)),
        )


class PyramidL3(fl.Chain):
    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.Sum(
                PyramidL4(embedding_dim=embedding_dim, device=device),
                fl.Chain(
                    fl.GetArg(2),
                    fl.Flatten(0, 1),
                    CBR(256, embedding_dim, device=device),  # output3
                    Unflatten(0, (-1, 5)),
                ),
            ),
            MCRM(embedding_dim, 64, device=device),  # dec_blk3
            fl.Flatten(0, 1),
            CBR(embedding_dim, device=device),  # conv3
            Interpolate((128, 128)),
        )


class PyramidL2(fl.Chain):
    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        embedding_dim = 128
        super().__init__(
            fl.Sum(
                PyramidL3(embedding_dim=embedding_dim, device=device),
                fl.Chain(
                    fl.GetArg(3),
                    fl.Flatten(0, 1),
                    CBR(128, embedding_dim, device=device),  # output2
                    Unflatten(0, (-1, 5)),
                ),
            ),
            MCRM(embedding_dim, 128, device=device),  # dec_blk2
            fl.Flatten(0, 1),
            CBR(embedding_dim, device=device),  # conv2
            Interpolate((128, 128)),
        )


class Pyramid(fl.Chain):
    """FPN-style neck over the 5-level multi-view pyramid."""

    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.Sum(
                PyramidL2(embedding_dim=embedding_dim, device=device),
                fl.Chain(
                    fl.GetArg(4),
                    fl.Flatten(0, 1),
                    CBR(128, embedding_dim, device=device),  # output1
                    Unflatten(0, (-1, 5)),
                ),
            ),
            MCRM(embedding_dim, 128, device=device),  # dec_blk1
            fl.Flatten(0, 1),
            CBR(embedding_dim, device=device),  # conv1
            Unflatten(0, (-1, 5)),
        )


class RearrangeMultiView(fl.Chain):
    """(b, 5, E, H, W) → (b, E, 2H, 2W): merge tiles + add global view."""

    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.Sum(
                fl.Chain(  # local tiles
                    fl.Slicing(dim=1, end=4),
                    PatchMerge(),
                ),
                fl.Chain(  # global view
                    fl.Slicing(dim=1, start=4),
                    fl.Squeeze(1),
                    Interpolate((256, 256)),
                ),
            ),
            fl.Chain(  # conv head
                CBR(embedding_dim, 384, device=device),
                CBR(384, device=device),
                fl.Conv2d(384, embedding_dim, kernel_size=3, padding=1, device=device),
            ),
        )


class ComputeShallow(fl.Passthrough):
    def __init__(self, embedding_dim: int = 128, device: Any = None) -> None:
        super().__init__(
            fl.Conv2d(3, embedding_dim, kernel_size=3, padding=1, device=device),
            fl.SetContext("mvanet", "shallow"),
        )


class MVANet(fl.Chain):
    """Multi-view dichotomous image segmentation.

    Input (1, 3, 1024, 1024); output (1, n_logits, 1024, 1024) logits.
    """

    def __init__(
        self,
        embedding_dim: int = 128,
        n_logits: int = 1,
        depths: list[int] | None = None,
        num_heads: list[int] | None = None,
        window_size: int = 12,
        device: Any = None,
    ) -> None:
        if depths is None:
            depths = [2, 2, 18, 2]
        if num_heads is None:
            num_heads = [4, 8, 16, 32]

        super().__init__(
            ComputeShallow(embedding_dim=embedding_dim, device=device),
            SplitMultiView(),
            fl.Flatten(0, 1),
            SwinTransformer(
                embedding_dim=embedding_dim,
                depths=depths,
                num_heads=num_heads,
                window_size=window_size,
                device=device,
            ),
            fl.Distribute(*(Unflatten(0, (-1, 5)) for _ in range(5))),
            Pyramid(embedding_dim=embedding_dim, device=device),
            RearrangeMultiView(embedding_dim=embedding_dim, device=device),
            ShallowUpscaler(embedding_dim, device=device),
            fl.Conv2d(embedding_dim, n_logits, kernel_size=3, padding=1, device=device),
        )

    def init_context(self) -> Contexts:
        return {"mvanet": {"shallow": None}}
