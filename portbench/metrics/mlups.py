"""mlups (MLUPS): every lattice-cell update of the window's jobs, summed over
instances (cells x steps x instances), over the window's seconds, from the
first job's start to the last one's end: per-job init and collate included."""


def read(rec):
    return rec.updates_per_job * len(rec.jobs) / rec.window_s / 1e6
