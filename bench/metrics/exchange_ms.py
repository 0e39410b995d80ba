"""exchange_ms: the device milliseconds of a round's exchange (the
master's K1 window and transfer plan), from the phase probe's CUDA
events, the mean over every round of the window (layer: the master,
``core/master.superstep``)."""


def read(record):
    rounds = record.get("rounds") or []
    if not rounds:
        return None
    return sum(r["exchange"] for r in rounds) * 1e3 / len(rounds)
