"""Host synchronizations per tracked frame, counted by torch's sync debug
mode over the traced window (the harness's own synchronizes left out)."""


def read(rec):
    if not rec.cuda or not rec.frames:
        return None
    return rec.counts["host_syncs"] / rec.frames
