"""launches_per_step (launches/step), layer wrappers: the device operations
(kernels, copies, fills) of the traced jobs over their steps."""


def read(rec):
    if rec.trace is None or not rec.trace["device"]:
        return None
    return len(rec.trace["device"]) / (rec.work.steps * rec.trace["jobs"])
