"""ensemble_us_per_instance_step (us), layer ensemble: the device time of the
program's kernels (names holding ``lbm_``) in the traced jobs, over instances x
steps x jobs; None outside an ensemble cell or without a trace."""


def read(rec):
    if rec.trace is None or not rec.ensemble:
        return None
    us = sum(b - a for name, cat, a, b in rec.trace["device"]
             if cat == "kernel" and "lbm_" in name)
    if us <= 0:
        return None
    return us / (rec.work.instances * rec.work.steps * rec.trace["jobs"])
