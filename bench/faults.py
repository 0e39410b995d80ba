"""Faults planted in the program's timed path, each a way the solver can
be wrong: the benchmark's comparison has to call every one not correct.
Each takes a ``setattr(module, name, value)`` (pytest's
``monkeypatch.setattr``, or :func:`plant`) and the cell's batch, and
replaces a name that ``repro_torch.core.dd.parallel.parallel_solve``
calls."""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "plant"]


def state_unchanged(setattr_, batch):
    """A superstep that hands its queues and carry back as it got them."""
    from repro_torch.core.dd import parallel

    setattr_(parallel, "_make_worker_body",
             lambda *a, **kw: lambda q, carry: (q, carry))


def half_batch(setattr_, batch):
    """Half of each lane's popped batch left out of the explore."""
    from repro_torch.core.dd import parallel

    explore = parallel.explore_batch

    def half(subs, valid, *a, **kw):
        valid = valid.reshape(-1, batch).clone()
        valid[:, batch // 2:] = False
        return explore(subs, valid.reshape(-1), *a, **kw)

    setattr_(parallel, "explore_batch", half)


def answer_altered(setattr_, batch):
    """Each explore's primal bound, where it is produced, one too high."""
    import torch

    from repro_torch.core.dd import parallel

    explore = parallel.explore_batch

    def altered(subs, valid, *a, **kw):
        out = explore(subs, valid, *a, **kw)
        out["primal"] = torch.where(valid, out["primal"] + 1, out["primal"])
        return out

    setattr_(parallel, "explore_batch", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


@contextlib.contextmanager
def plant(name: str, batch: int):
    """Fault ``name`` in place for the block."""
    saved = []

    def setattr_(module, attr, value):
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    FAULTS[name](setattr_, batch)
    try:
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)
