"""Mean ms of the Frontend calls that initialize or update the local
window (edge proposal, update steps, keyframe removal, loop closing)."""


def _works(fe, *a, **k):
    return (not fe.is_initialized and fe.video.counter == fe.warmup) or \
        (fe.is_initialized and fe.t1 < fe.video.counter)


def install(rec):
    from goslam_tpu_torch.tracking.frontend import Frontend
    rec.span(Frontend, "__call__", "frontend", when=_works)


def read(rec):
    s = rec.spans.get("frontend")
    return 1e3 * sum(s) / len(s) if s else None
