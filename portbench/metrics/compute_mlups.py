"""compute_mlups (MLUPS), layer driver: the cell updates of the window's jobs
over the sum of their compute brackets (``models/driver.py``'s ``PhaseTimer``
"compute", which ends in a synchronize); None where the program keeps no
phases (the ensemble)."""


def read(rec):
    compute = [j.phases["compute"] for j in rec.jobs if j.phases]
    if not compute or len(compute) < len(rec.jobs):
        return None
    return rec.updates_per_job * len(compute) / sum(compute) / 1e6
