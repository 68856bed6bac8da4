"""kernels_roofline (%), layer kernels: the traced jobs' least time
(``portbench.roofline``: their operations over the float32 peak, or their
compulsory bytes over the memory peak, whichever is longer) over the summed
device time of every kernel they ran."""

from portbench import roofline


def read(rec):
    if rec.trace is None:
        return None
    us = sum(b - a for _, cat, a, b in rec.trace["device"] if cat == "kernel")
    if us <= 0:
        return None
    least, _ = roofline.bound_seconds(rec.work)
    return 100.0 * least * rec.trace["jobs"] / (us * 1e-6)
