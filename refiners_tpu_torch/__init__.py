"""PyTorch/CUDA port of refiners_tpu: the SDXL text-to-image path on one
NVIDIA H100, with hand-written Hopper kernels in place of the JAX package's
Pallas kernels. The JAX package (`refiners_tpu`) is the reference this port
is held against; see README.md's "PyTorch/CUDA port" section."""

__version__ = "0.1.0"
