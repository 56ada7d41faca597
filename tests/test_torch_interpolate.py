"""The port's `interpolate` against the JAX package's, for every mode the JAX
package takes, on the CPU.

Images are seeded normals in float32 (values up to ~4), NHWC to JAX and NCHW
to the port, resized up and down and to sizes that are not square. Each
package builds its own float32 weights (the JAX package's bicubic and, through
``jax.image.resize``, its bilinear and lanczos3; the port's bilinear and
bicubic through ``torch.nn.functional.interpolate``, its lanczos3 by the same
rule as JAX), so they agree to float32 rounding: 2e-5 absolute.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refiners_tpu.fluxion.utils import interpolate as jax_interpolate
from refiners_tpu_torch.conversion import nchw_to_nhwc
from refiners_tpu_torch.fluxion.utils import interpolate

TOL = 2e-5
MODES = [
    ("nearest", False),
    ("bilinear", False),
    ("bilinear", True),
    ("bicubic", False),
    ("bicubic", True),
    ("lanczos", False),
    ("lanczos", True),
]
SIZES = [(16, 16), (74, 50), (50, 74), (37, 37), (100, 90), (9, 61)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode,antialias", MODES)
def test_interpolate_matches_jax(mode: str, antialias: bool, size: tuple[int, int]) -> None:
    """37 × 37 (DINOv2's position grid) to downscales, upscales, the same
    size and mixed ones."""
    x = np.random.RandomState(0).randn(2, 3, 37, 37).astype(np.float32)
    want = np.asarray(jax_interpolate(jnp.asarray(nchw_to_nhwc(x)), size, mode=mode, antialias=antialias))
    got = interpolate(torch.from_numpy(x), size, mode=mode, antialias=antialias)
    assert got.shape == (2, 3, *size) and got.dtype == torch.float32
    np.testing.assert_allclose(nchw_to_nhwc(got.numpy()), want, atol=TOL)


def test_lanczos_without_antialias_does_not_widen_a_downscale() -> None:
    """``lanczos`` with the default ``antialias=False`` (which raised before)
    is JAX's lanczos3: at a downscale its three-pixel kernel is not widened.
    A 2× downscale of a checkerboard of 2 × 2 squares keeps the squares (and
    rings past them), where the antialiased one halves their contrast."""
    i, j = np.indices((32, 32))
    board = ((i // 2 + j // 2) % 2).astype(np.float32)[None, None]
    x = torch.from_numpy(board)
    sharp = interpolate(x, (16, 16), mode="lanczos")
    smooth = interpolate(x, (16, 16), mode="lanczos", antialias=True)
    want = np.asarray(jax_interpolate(jnp.asarray(nchw_to_nhwc(board)), (16, 16), mode="lanczos"))
    np.testing.assert_allclose(nchw_to_nhwc(sharp.numpy()), want, atol=TOL)
    assert float(sharp[..., 4:12, 4:12].std()) > 1.0 > 0.3 > float(smooth[..., 4:12, 4:12].std())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_interpolate_keeps_the_dtype(dtype: torch.dtype) -> None:
    """Each mode computes in float32 and returns the input's dtype."""
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 20, 30).astype(np.float32))
    for mode, antialias in MODES:
        got = interpolate(x.to(dtype), (13, 41), mode=mode, antialias=antialias)
        want = interpolate(x.to(dtype).float(), (13, 41), mode=mode, antialias=antialias)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want.to(dtype), atol=0, rtol=0)
