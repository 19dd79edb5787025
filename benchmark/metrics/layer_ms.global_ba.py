"""Mean ms of Backend.dense_ba, global BA every tracking.global_ba_every
keyframes (edge proposal, the low-memory steps: alt-corr, update
operator, DBA)."""


def install(rec):
    from goslam_tpu_torch.tracking.backend import Backend
    rec.span(Backend, "dense_ba", "global_ba")


def read(rec):
    s = rec.spans.get("global_ba")
    return 1e3 * sum(s) / len(s) if s else None
