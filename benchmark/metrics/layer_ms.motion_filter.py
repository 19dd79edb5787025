"""Mean ms of MotionFilter.track (the encoders of every view, one update
iteration against the last keyframe, the admit test), one span a frame."""


def install(rec):
    from goslam_tpu_torch.tracking.motion_filter import MotionFilter
    rec.span(MotionFilter, "track", "motion_filter")


def read(rec):
    s = rec.spans.get("motion_filter")
    return 1e3 * sum(s) / len(s) if s else None
