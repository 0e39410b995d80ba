"""Crash- and preemption-safe driving of the steal runtime (PyTorch port
of ``repro.launch.resilient``).

:func:`run_resilient` is the glue the resilience layer promises: periodic
queue snapshots (``StealRuntime.attach_snapshots`` — atomic, at round
boundaries), SIGTERM / SIGINT handled as a final snapshot and a clean
exit (:class:`repro_torch.train.fault.GracefulExit`), and crash recovery
via :func:`repro_torch.train.fault.run_supervised` — an unhandled
exception rebuilds the runtime, restores the latest snapshot (the exact
queue state) and resumes the drive loop.

The CLI is a demonstration harness::

  PYTHONPATH=src python -m repro_torch.launch.resilient --device cpu \\
      --snapshot-dir /tmp/steal_snap --simulate-crash-at 6

crashes the drive loop at round 6 on the first attempt, then shows the
supervised restart resuming from the last snapshot and draining to
completion.  Without ``--device`` it runs on the GPU.  With
``--metrics-path FILE`` it also keeps a Prometheus textfile of the
runtime's metrics there, rewritten between rounds at most once every
``--metrics-every-s`` seconds and once more at the end.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Callable, Optional

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import GracefulExit, run_supervised

__all__ = ["run_resilient"]


def run_resilient(make_runtime: Callable[[], "object"],
                  drive: Callable[["object", Callable[[], bool]], int], *,
                  snapshot_dir: str,
                  snapshot_every: int = 8,
                  keep: int = 3,
                  max_restarts: int = 3,
                  on_restart: Optional[Callable] = None,
                  metrics_path: Optional[str] = None,
                  metrics_every_s: float = 1.0) -> int:
    """Run ``drive(runtime, should_stop)`` under snapshot + restart
    supervision.

    Args:
      make_runtime: builds a FRESH runtime (once per attempt — after a
        crash the old device state is gone by assumption).
      drive: the workload loop; called with the runtime and a
        ``should_stop()`` callable that turns True on SIGTERM / SIGINT —
        check it between rounds and return early (a final snapshot is
        written either way).  Returns an int (e.g. rounds run).
      snapshot_dir / snapshot_every / keep: the snapshot cadence; on
        (re)start the LATEST snapshot under ``snapshot_dir`` is restored
        when one exists, so a new process pointed at the same directory
        resumes where the dead one left off.
      max_restarts / on_restart: forwarded to ``run_supervised``.
      metrics_path / metrics_every_s: when ``metrics_path`` is set, the
        ``should_stop`` callable the drive loop already polls between
        rounds ALSO refreshes a Prometheus textfile there (atomic
        tmp + rename via :func:`repro_torch.obs.metrics.write_textfile`,
        at most one write per ``metrics_every_s``, on ``time.monotonic``)
        — the node-exporter textfile-collector contract, so a live run is
        scrapable with no change to the drive loop.  A final write lands
        after the loop exits.
    """

    def attempt(resume) -> int:
        rt = make_runtime()
        rt.attach_snapshots(snapshot_dir, every=snapshot_every, keep=keep)
        if ckpt_lib.latest_step(snapshot_dir) is not None:
            rt.restore_state(snapshot_dir)
            if resume is not None:
                rt.telemetry.record_fault("restart")

        def write_metrics() -> None:
            from repro_torch.obs.metrics import write_textfile

            write_textfile(rt.metrics(), metrics_path)

        with GracefulExit() as stop:
            if metrics_path is None:
                should_stop = lambda: stop.requested  # noqa: E731
            else:
                last = [float("-inf")]

                def should_stop() -> bool:
                    now = time.monotonic()
                    if now - last[0] >= metrics_every_s:
                        last[0] = now
                        write_metrics()
                    return stop.requested

            result = drive(rt, should_stop)
            # A graceful exit's final state may postdate the last cadence
            # snapshot; save it so the NEXT process resumes exactly here.
            rt.save_state(snapshot_dir, keep=keep)
            if metrics_path is not None:
                write_metrics()
        return result

    return run_supervised(attempt, max_restarts=max_restarts,
                          on_restart=on_restart)


def main(argv: Optional[list] = None) -> int:
    import numpy as np
    import torch

    from repro_torch.core.policy import StealPolicy
    from repro_torch.runtime import FaultPlan, StealRuntime

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--snapshot-dir", default=None,
                    help="default: a fresh temporary directory")
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-crash-at", type=int, default=0,
                    help="raise mid-drive at this round on attempt 0")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    ap.add_argument("--metrics-path", default=None,
                    help="write a Prometheus textfile here between rounds "
                         "(atomic; node-exporter textfile collector format)")
    ap.add_argument("--metrics-every-s", type=float, default=1.0)
    args = ap.parse_args(argv)
    snapshot_dir = args.snapshot_dir or tempfile.mkdtemp(prefix="steal_snap_")
    crashed = {"done": False}

    def make_runtime():
        rt = StealRuntime(args.workers, args.capacity,
                          {"x": torch.zeros((), dtype=torch.int32)},
                          policy=StealPolicy(), fault_plan=FaultPlan(),
                          device=args.device)
        if ckpt_lib.latest_step(snapshot_dir) is None:
            rng = np.random.default_rng(args.seed)
            split = rng.multinomial(args.items,
                                    np.ones(args.workers) / args.workers)
            base = 0
            for w, n in enumerate(split):
                if n:
                    rt.push(w, {"x": torch.arange(base, base + int(n),
                                                  dtype=torch.int32)}, int(n))
                base += int(n)
        return rt

    def drive(rt, should_stop) -> int:
        ops = rt.ops

        def worker(q, carry):
            # Toy worker: consume up to 4 items per lane per round.
            q, _batch, n = ops.pop_bulk(q, 4, 4)
            return q, carry + n

        for _ in range(args.rounds):
            if should_stop():
                print(f"[resilient] graceful stop at round {rt.rounds_run}")
                break
            if (args.simulate_crash_at and not crashed["done"]
                    and rt.rounds_run >= args.simulate_crash_at):
                crashed["done"] = True
                raise RuntimeError(
                    f"simulated crash at round {rt.rounds_run}")
            rt.round(worker)
            if rt.total_size() == 0:
                break
        print(f"[resilient] rounds_run={rt.rounds_run} "
              f"remaining={rt.total_size()} "
              f"faults={rt.telemetry.fault_events}")
        return rt.rounds_run

    rounds = run_resilient(make_runtime, drive, snapshot_dir=snapshot_dir,
                           snapshot_every=args.snapshot_every,
                           metrics_path=args.metrics_path,
                           metrics_every_s=args.metrics_every_s)
    print(f"[resilient] finished after {rounds} global rounds "
          f"(snapshots in {snapshot_dir})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
