"""The device's idle share of the traced window: 100 x (1 - the union of
the intervals in which a device operation ran / the window)."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
