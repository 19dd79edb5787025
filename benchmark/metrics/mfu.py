"""DroidNet's share of the chip's bf16 peak over the traced window: the
FLOPs of every encoder, update-operator and GraphAgg call at its input
shapes (formulas.py) over the window's seconds x 989 TFLOP/s."""

from harness import formulas


def install(rec):
    rec.droidnet_flops()


def read(rec):
    if not rec.cuda or not rec.window_s or not rec.flops:
        return None
    return 100.0 * rec.flops / (rec.window_s
                                * formulas.PEAKS["bf16_flops_s"])
