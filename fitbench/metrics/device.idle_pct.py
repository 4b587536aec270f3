"""device.idle_pct: the share of the traced fits' wall with no kernel or
copy on the card."""


def read(run):
    tr = run.traced
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
