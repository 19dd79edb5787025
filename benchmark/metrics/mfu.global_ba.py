"""DroidNet's share of the chip's bf16 peak inside global BA: the FLOPs
of the update-operator and GraphAgg calls made within Backend.dense_ba
(formulas.py) over the time of those calls x 989 TFLOP/s.  The whole
step whose kernel alt_corr_roofline reads."""

from harness import formulas


def install(rec):
    from goslam_tpu_torch.tracking.backend import Backend
    rec.span(Backend, "dense_ba", "global_ba")
    rec.droidnet_flops()


def read(rec):
    s = rec.spans.get("global_ba")
    f = rec.flops_in.get("global_ba")
    if not s or not f:
        return None
    return 100.0 * f / (sum(s) * formulas.PEAKS["bf16_flops_s"])
