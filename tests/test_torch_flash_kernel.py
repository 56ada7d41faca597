"""The hand-written flash attention kernel against its plain version, on the card.

These tests need an NVIDIA card with nvcc (sm_90a) and skip elsewhere. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py -q
"""

from __future__ import annotations

import pytest
import torch

from refiners_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain

pytestmark = pytest.mark.cuda

# bf16 unit roundoff is 3.9e-3 and the kernel rounds P and O once each; the
# plain version runs in float32 from the same bf16 inputs
TOL = 1e-2


@pytest.fixture
def device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(device: torch.device, batch: int, lq: int, lk: int, width: int, dtype: torch.dtype) -> list[torch.Tensor]:
    gen = torch.Generator(device).manual_seed(lq * 7 + lk + width)
    return [torch.randn((batch, n, width), generator=gen, device=device).to(dtype) for n in (lq, lk, lk)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal,dtype",
    [
        (2, 256, 320, 4, 64, False, torch.bfloat16),
        (1, 200, 300, 8, 40, False, torch.bfloat16),  # head_dim not a multiple of 16
        (1, 256, 256, 1, 512, False, torch.bfloat16),
        (2, 256, 256, 4, 64, True, torch.bfloat16),
        (2, 1000, 1100, 5, 64, False, torch.bfloat16),
        (1, 4096, 4096, 10, 64, False, torch.float16),
        (3, 77, 77, 12, 64, True, torch.bfloat16),
        (1, 300, 260, 3, 128, False, torch.bfloat16),
        (2, 200, 200, 2, 80, True, torch.float16),
        (1, 130, 150, 2, 256, False, torch.bfloat16),  # between the two kernels' ranges
    ],
)
def test_kernel_matches_plain(
    device: torch.device, batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool, dtype: torch.dtype
) -> None:
    q, k, v = _qkv(device, batch, lq, lk, heads * dim, dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, is_causal=causal, head_dim=dim)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=causal, head_dim=dim)
    assert _rel(got, want) <= TOL


def test_kernel_reads_strided_heads(device: torch.device) -> None:
    """q, k, v as column slices of one fused projection (row stride 3·H·D)."""
    qkv = torch.randn((2, 512, 3 * 256), device=device).bfloat16()
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    got = flash_attention_packed(q, k, v, head_dim=64)
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), head_dim=64)
    assert _rel(got, want) <= TOL


def test_causal_rows_without_keys_get_uniform_weights(device: torch.device) -> None:
    q, k, v = _qkv(device, 1, 300, 200, 128, torch.bfloat16)
    got = flash_attention_packed(q, k, v, is_causal=True, head_dim=64).float()
    uniform = v.float().mean(dim=1, keepdim=True).expand(1, 100, 128)
    assert _rel(got[:, :100], uniform) <= TOL


def test_kernel_refuses_what_it_does_not_take(device: torch.device) -> None:
    q, k, v = _qkv(device, 1, 64, 64, 128, torch.float32)
    with pytest.raises(TypeError):
        flash_attention_packed(q, k, v, head_dim=64)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, head_dim=12)
    with pytest.raises(NotImplementedError):
        flash_attention_packed(q.requires_grad_(), k, v, head_dim=64)
