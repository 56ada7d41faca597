"""The flash-routed attention's share of its roofline, per image: the
least time the card could take for the attention calls that the cell's
shapes fix (the U-Net's self-attention at 1024 tokens or more, at the CFG
batch, every step; the decoder's one-head attention), over the device time
of the kernels that compute them (`KERNELS`, matched in the operation's
name). The bound is the larger of operations at 989 TFLOP/s and bytes at
3.35 TB/s, per call."""

from h100_bench.reference.flops import attention_bound_s, attention_sites

# the port's forward kernels, and PyTorch's fused attention should a site be routed there
KERNELS = ("flash_fwd_narrow_kernel", "flash_fwd_wgmma_kernel", "pytorch_flash::flash_fwd", "fmha_cutlassF")


def read(run):
    s, cfg, mix = run.stretch, run.cell.cfg, run.cell.mix
    if s is None:
        return None
    kernel_s = sum(t for name, t in s.kernels.items() if any(k in name for k in KERNELS))
    if not kernel_s or not s.items:
        return None
    size, n = tuple(mix["size"]), mix["num_images"]
    steps = cfg["solver"]["num_inference_steps"]
    per_request = steps * attention_bound_s(attention_sites(cfg, size, 2 * n, decode=False))
    per_request += n * attention_bound_s(attention_sites(cfg, size, 0, decode=True)[-1:])
    return 100 * (per_request / n) / (kernel_s / s.items)
