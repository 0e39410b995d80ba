"""explore_roofline_pct: the least time the card needs for the window's
explores (the larger of their operations, counted from their inputs by
``bench/opcount.py``, at the int32 rate and their bytes at the memory
rate), as a share of the device time of the operations launched inside
the benchmark's spans around ``explore_batch`` (layer: the DD bounds,
``bnb.explore_batch`` and ``explore.cu``)."""


def read(record):
    trace, counts, peak = (record.get("trace"), record.get("counts"),
                           record.get("peak"))
    if not trace or not counts or not peak:
        return None
    device_s = trace["explore_device_s"]
    if not device_s or counts["explore_ops"] is None:
        return None
    bound_s = max(counts["explore_ops"] / peak["int32_ops_per_s"],
                  counts["explore_bytes"] / peak["mem_bytes_per_s"])
    return 100.0 * bound_s / device_s
