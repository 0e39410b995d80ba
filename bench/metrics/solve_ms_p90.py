"""solve_ms_p90: the 90th percentile of the milliseconds from the call to
``parallel_solve`` until the optimum is on the host, over every solve of
the window."""

import numpy as np


def read(record):
    ms = [s["ms"] for s in record["solves"]]
    return float(np.percentile(ms, 90)) if ms else None
