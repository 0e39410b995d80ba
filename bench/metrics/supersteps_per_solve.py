"""supersteps_per_solve: the mean of ``stats["supersteps"]`` over the
solves of the window (layer: the solver entry, ``parallel_solve``)."""


def read(record):
    steps = [s["supersteps"] for s in record["solves"]
             if s["supersteps"] is not None]
    return sum(steps) / len(steps) if steps else None
