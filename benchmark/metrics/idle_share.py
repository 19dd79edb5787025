"""Percent of the traced window in which no kernel or copy ran on the
device: 1 - the union of the profile's device intervals / the window."""


def read(rec):
    p = rec.profile
    if p is None or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
