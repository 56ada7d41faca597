"""The whole training step's share of the card's bf16 peak: the U-Net's
forward and backward operations per sample (`reference.flops.sample_flops`;
products and convolutions only, the optimizer's elementwise work not
counted) times the samples per second of the traced run's unprofiled
window, over 989 TFLOP/s."""

from h100_bench.reference.flops import PEAK_BF16_FLOPS, sample_flops


def read(run):
    if not run.window_s or not run.items:
        return None
    mix = run.cell.mix
    flops = sample_flops(run.cell.cfg, tuple(mix["size"]), mix["batch_size"])
    return 100 * flops * run.items / run.window_s / PEAK_BF16_FLOPS
