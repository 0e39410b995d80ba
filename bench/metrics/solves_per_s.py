"""solves_per_s: solves completed to a proven optimum in the window, over
the window's seconds (the window closes when the last solve started in
it returns)."""


def read(record):
    if record.get("window_s") is None:
        return None
    done = sum(1 for s in record["solves"] if s["ok"])
    return done / record["window_s"]
