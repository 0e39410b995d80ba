"""launches_per_superstep: device operations (kernels, copies, sets) in
the profiler's trace of the window, over the window's supersteps (layer:
the host loop, which issues each one)."""


def read(record):
    trace = record.get("trace")
    steps = sum(s["supersteps"] or 0 for s in record["solves"])
    if not trace or not trace["device_ops"] or not steps:
        return None
    return trace["device_ops"] / steps
