"""device_idle_pct: the share of the host-timed traced window in which no
operation ran on the device (1 - the union of the device operations'
intervals over the window)."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["device_ops"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / record["window_s"])
