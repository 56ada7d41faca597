"""The whole request's share of the card's bf16 peak: the operations of
one image (`reference.flops.image_flops`: both prompts encoded, the U-Net
at every step, the decode; products and convolutions only) times the
images per second of the traced run's unprofiled window, over 989 TFLOP/s."""

from h100_bench.reference.flops import PEAK_BF16_FLOPS, image_flops


def read(run):
    if not run.window_s or not run.items:
        return None
    return 100 * image_flops(run.cell.cfg, tuple(run.cell.mix["size"])) * run.items / run.window_s / PEAK_BF16_FLOPS
