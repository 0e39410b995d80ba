"""superstep_ms: the traced window's milliseconds on the host clock over
every superstep the window's solves ran (layer: the host loop,
``runtime/executor.StealRuntime``)."""


def read(record):
    steps = sum(s["supersteps"] or 0 for s in record["solves"])
    return record["window_s"] * 1e3 / steps if steps else None
