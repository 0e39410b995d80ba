"""worker_body_ms: the device milliseconds of a round's worker body (K3
pop, the explore, prune and compaction, K2 push), from the phase probe's
CUDA events, the mean over every round of the window (layer: the worker
body, ``parallel._make_worker_body``)."""


def read(record):
    rounds = record.get("rounds") or []
    if not rounds:
        return None
    return sum(r["worker_body"] for r in rounds) * 1e3 / len(rounds)
