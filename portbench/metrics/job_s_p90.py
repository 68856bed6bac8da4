"""job_s_p90 (s): the 90th percentile of time to solution over every job of
the window, from the call into the program to its outputs on the host."""

from portbench import stats


def read(rec):
    return stats.percentile([j.end - j.start for j in rec.jobs], 90)
