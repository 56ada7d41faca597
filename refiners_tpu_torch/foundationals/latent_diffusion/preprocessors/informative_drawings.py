"""Line-art preprocessor net (arXiv:2203.12691), for the Lineart ControlNet;
counterpart of
``refiners_tpu/foundationals/latent_diffusion/preprocessors/informative_drawings.py``.
NCHW: RGB in [0, 1] to one grayscale channel."""

from __future__ import annotations

from typing import Any

import refiners_tpu_torch.fluxion.layers as fl


class InformativeDrawings(fl.Chain):
    """Use "Style 2" weights when preprocessing for Lineart ControlNet."""

    def __init__(
        self,
        in_channels: int = 3,  # RGB
        out_channels: int = 1,  # grayscale
        n_residual_blocks: int = 3,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            fl.Chain(  # initial convolution
                fl.ReflectionPad2d(3),
                fl.Conv2d(in_channels=in_channels, out_channels=64, kernel_size=7, device=device, dtype=dtype),
                fl.InstanceNorm2d(64, device=device, dtype=dtype),
                fl.ReLU(),
            ),
            *(  # downsampling
                fl.Chain(
                    fl.Conv2d(
                        in_channels=64 * (2**i),
                        out_channels=128 * (2**i),
                        kernel_size=3,
                        stride=2,
                        padding=1,
                        device=device,
                        dtype=dtype,
                    ),
                    fl.InstanceNorm2d(128 * (2**i), device=device, dtype=dtype),
                    fl.ReLU(),
                )
                for i in range(2)
            ),
            *(  # residual blocks
                fl.Residual(
                    fl.ReflectionPad2d(1),
                    fl.Conv2d(in_channels=256, out_channels=256, kernel_size=3, device=device, dtype=dtype),
                    fl.InstanceNorm2d(256, device=device, dtype=dtype),
                    fl.ReLU(),
                    fl.ReflectionPad2d(1),
                    fl.Conv2d(in_channels=256, out_channels=256, kernel_size=3, device=device, dtype=dtype),
                    fl.InstanceNorm2d(256, device=device, dtype=dtype),
                )
                for _ in range(n_residual_blocks)
            ),
            *(  # upsampling
                fl.Chain(
                    fl.ConvTranspose2d(
                        in_channels=128 * (2**i),
                        out_channels=64 * (2**i),
                        kernel_size=3,
                        stride=2,
                        padding=1,
                        output_padding=1,
                        device=device,
                        dtype=dtype,
                    ),
                    fl.InstanceNorm2d(64 * (2**i), device=device, dtype=dtype),
                    fl.ReLU(),
                )
                for i in reversed(range(2))
            ),
            fl.Chain(  # output layer
                fl.ReflectionPad2d(3),
                fl.Conv2d(in_channels=64, out_channels=out_channels, kernel_size=7, device=device, dtype=dtype),
                fl.Sigmoid(),
            ),
        )
