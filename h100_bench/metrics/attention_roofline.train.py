"""The flash-routed attention's share of its roofline in training, per
sample: the least time for the U-Net's self-attention calls at 1024 tokens
or more, forward (4 operations per query-key-dimension) and backward (10:
the scores again, dV, dP, dQ, dK), over the device time of the kernels
that compute them (`KERNELS`). The bound is the larger of operations at
989 TFLOP/s and bytes at 3.35 TB/s, per call."""

from h100_bench.reference.flops import attention_bound_s, attention_sites

KERNELS = (
    "flash_fwd_narrow_kernel", "flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
    "flash_bwd_wide_wgmma_kernel", "pytorch_flash::flash_fwd", "pytorch_flash::flash_bwd", "fmha_cutlassF", "fmha_cutlassB",
)  # fmt: skip


def read(run):
    s, cfg, mix = run.stretch, run.cell.cfg, run.cell.mix
    if s is None:
        return None
    kernel_s = sum(t for name, t in s.kernels.items() if any(k in name for k in KERNELS))
    if not kernel_s or not s.items:
        return None
    batch = mix["batch_size"]
    per_step = attention_bound_s(attention_sites(cfg, tuple(mix["size"]), batch, decode=False), backward=10.0)
    return 100 * (per_step / batch) / (kernel_s / s.items)
