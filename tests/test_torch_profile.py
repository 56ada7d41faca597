"""The profiler's kinds table (`refiners_tpu_torch/examples/profile_train.py`)
on kernel names recorded by `torch.profiler` on an H100 (the first 160
characters, as `device_breakdown` prints its top kernels in `chip_smoke.py`)."""

from __future__ import annotations

import pytest

from refiners_tpu_torch.examples.profile_train import _kind

ARITHMETIC, COPIES = "elementwise arithmetic (no cast)", "copies and casts"
RECORDED = [
    (
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor"
        "<float, float, float, at::native::binary_internal::MulFu",
        ARITHMETIC,
    ),
    (
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add"
        "<float> >(at::TensorIteratorBase&, at::native::CUDAFun",
        ARITHMETIC,
    ),
    (
        "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add"
        "<c10::BFloat16> >(at::TensorIteratorBase&, at::native:",
        ARITHMETIC,
    ),
    (
        "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::"
        "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::opera",
        COPIES,
    ),
    (
        "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
        "{lambda()#3}::operator()() const::{lambda()#7}::opera",
        COPIES,
    ),
    (
        "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::WelfordOps<float, float, int, "
        "thrust::THRUST_200700_750_800_860_900_1000_1200_NS:",
        "norm statistics and reductions",
    ),
    (
        "void (anonymous namespace)::flash_fwd_narrow_kernel<__nv_bfloat16, 80, 2>(CUtensorMap_st, CUtensorMap_st, "
        "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtens",
        "attention (flash kernels)",
    ),
    (
        "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true, "
        "(cudnnKernelDataType_t)0>(cudnn::engines_precompiled::nchw2n",
        "convolution",
    ),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "matmul"),
    (
        "void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>(cutlass_80_tensorop_"
        "i16832gemm_s8_128x64_128x3_tn_align16::Params)",
        "matmul",
    ),
]


@pytest.mark.parametrize(("name", "kind"), RECORDED, ids=[f"{i}-{kind}" for i, (_, kind) in enumerate(RECORDED)])
def test_kind_files_each_kernel_by_what_it_does(name: str, kind: str) -> None:
    """PyTorch's arithmetic on operands of one dtype (`gpu_kernel_impl_nocast`)
    is not a cast; a copy is a copy whichever template runs it."""
    assert _kind(name) == kind
