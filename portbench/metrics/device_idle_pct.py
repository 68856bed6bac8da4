"""device_idle_pct (%), layer device: the share of the traced window, from
the first traced job's start to the last one's end, gaps between jobs
included, in which no operation ran on the card."""


def read(rec):
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
