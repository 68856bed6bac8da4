"""init_ms (ms), layer driver: the median over the window's jobs of the
``PhaseTimer`` "init" of ``models/driver.py`` (program build, buffers, the warm launch);
None where the program keeps no phases."""

import statistics


def read(rec):
    init = [j.phases["init"] for j in rec.jobs if j.phases]
    return 1e3 * statistics.median(init) if init else None
