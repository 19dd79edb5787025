"""Mean ms of a mapping round: the multiview filter and, when it
published, the mapper's round (training steps of the InstantNeuS)."""


def install(rec):
    from goslam_tpu_torch.mapping.mapper import Mapper
    from goslam_tpu_torch.tracking.multiview_filter import MultiviewFilter
    rec.span(MultiviewFilter, "__call__", "multiview_filter")
    rec.span(Mapper, "__call__", "mapper")


def read(rec):
    rounds = rec.spans.get("multiview_filter")
    if not rounds:
        return None
    return 1e3 * (sum(rounds) + sum(rec.spans.get("mapper", []))) \
        / len(rounds)
