"""Kind ``dd-knapsack``: the DD branch-and-bound solver of ``repro_torch``
(``core/dd/parallel.parallel_solve``) on Pisinger's knapsack series.

The program is ``parallel_solve`` with the configuration's solver
settings; an item is one instance of the cell's pool (traffic generator
``pisinger_series``: the pool's seed and size in whole series, the block
within which ``--seed`` reorders it, the warm-up instance), drawn with the
configuration's class, n, R and H; the check compares each solve's
optimum with the plain dynamic program of ``bench/reference``.  In a
traced run :class:`Hooks` puts the benchmark's spans around the solver's
layers.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

from bench import opcount, tracing
from bench.reference import pisinger

__all__ = ["LAUNCH_RUNTIME", "ROUNDS", "WORKER_BODY", "EXPLORE",
           "program", "items", "warm_item", "argument", "record", "check",
           "Hooks"]

LAUNCH_RUNTIME = "bench.launch_runtime"
ROUNDS = "bench.run_fused"
WORKER_BODY = "bench.worker_body"
EXPLORE = "bench.explore"

# The series whose draw gives the warm-up instance: far past any series
# of a pool, so the warm solve is never one of the window's.
WARM_CYCLE = 2 ** 31


def program(config: dict, device):
    """``parallel_solve`` with the configuration's solver settings: a
    function of a Knapsack that returns ``(optimum, stats)``."""
    from repro_torch.core.dd import parallel
    from repro_torch.core.policy import StealPolicy

    s = config["solver"]
    policy = StealPolicy(**s["policy"])

    def solve(inst):
        return parallel.parallel_solve(
            inst, n_workers=s["n_workers"], explore_width=s["explore_width"],
            batch=s["batch"], capacity=s["capacity"], policy=policy,
            max_supersteps=s["max_supersteps"], adaptive=s["adaptive"],
            fused_rounds=s["fused_rounds"], execution=s["execution"],
            device=device)

    return solve


# -- the traffic --------------------------------------------------------------


def _kw(traffic: dict, config: dict) -> dict:
    if traffic["generator"] != "pisinger_series":
        raise ValueError(f"unknown generator {traffic['generator']!r}")
    return dict(kind=config["class"], n=int(config["n"]), r=int(config["R"]),
                H=int(config["H"]))


def items(traffic: dict, config: dict, seed: int
          ) -> Iterator[pisinger.Instance]:
    """The closed loop's stream: pass after pass over the cell's pool,
    each block of ``traffic["block"]`` instances in an order drawn from
    ``seed``."""
    kw = _kw(traffic, config)
    return pisinger.stream(seed, pisinger.pool(
        traffic["pool_seed"], traffic["pool_cycles"], **kw),
        traffic["block"])


def warm_item(traffic: dict, config: dict, seed: int) -> pisinger.Instance:
    """Instance ``traffic["warm_h"]`` of a series drawn apart from the
    pool."""
    for inst in pisinger.cycle(traffic["pool_seed"], WARM_CYCLE,
                               order="ascending", **_kw(traffic, config)):
        if inst.h == traffic["warm_h"]:
            return inst
    raise ValueError(f"warm_h {traffic['warm_h']} is not in the series")


# -- one solve and the check --------------------------------------------------


def argument(inst: pisinger.Instance):
    """The program's argument for an instance."""
    from repro_torch.core.dd.knapsack import Knapsack

    return Knapsack(inst.weights, inst.profits, inst.capacity)


def record(config: dict, inst: pisinger.Instance, out, ms: float,
           error) -> dict:
    """One solve's record: ``ok`` once it proved its optimum before
    ``max_supersteps``."""
    opt, stats = out if error is None else (None, {})
    steps = stats.get("supersteps")
    return {
        "inst": inst, "h": inst.h, "ms": ms, "optimum": opt,
        "error": error, "supersteps": steps,
        "transferred": stats.get("transferred"),
        "ok": error is None and steps is not None
        and steps < config["solver"]["max_supersteps"]}


def check(solves: list) -> dict:
    """Every solve's optimum against the plain dynamic program: the
    numbers compared, each with its limit."""
    from bench.reference.optimum import optimum

    for s in solves:
        i = s.pop("inst")
        s["right"] = s["error"] is None and s["optimum"] == optimum(
            i.weights, i.profits, i.capacity)
    returned = [s for s in solves if s["error"] is None]
    return {
        "raised": {"value": len(solves) - len(returned), "limit": 0},
        "unproven": {"value": sum(not s["ok"] for s in returned),
                     "limit": 0},
        "wrong_optimum": {"value": sum(not s["right"] for s in returned),
                          "limit": 0},
    }


# -- the traced run -----------------------------------------------------------


class Hooks:
    """The traced run's wrappers on ``repro_torch.core.dd.parallel``:
    ``launch_runtime`` (a span, and the runtime's phase probe armed so
    that every round records the device time of its worker body and its
    exchange), ``run_fused`` (a span a block of rounds),
    ``_make_worker_body`` (a span a worker body) and ``explore_batch`` (a
    span an explore, and the explore's inputs counted for its operations
    inside ``bench.instrument`` spans, whose host seconds ``superstep_ms``
    and ``worker_body_ms`` include).  Nothing is wrapped in an untraced
    run."""

    # innermost first: the host activity an idle gap is charged to
    SPANS = (EXPLORE, WORKER_BODY, ROUNDS, LAUNCH_RUNTIME)
    # the device time of the operations launched inside each span
    KERNELS = {"explore": EXPLORE}

    def __init__(self, torch) -> None:
        from repro_torch.core.dd import parallel

        self.parallel = parallel
        self.rf = torch.profiler.record_function
        self.saved: Dict[str, object] = {}
        self.runtimes: list = []
        self.rounds: List[Dict[str, float]] = []
        self.explore_calls = 0
        self.explore_bytes = 0
        self.width = None
        self._layers = None      # device: layers the explores walk

    # -- counting, inside bench.instrument spans ---------------------------

    def note_explore(self, layer, valid, *, width: int, n_vars: int) -> None:
        with self.rf(tracing.INSTRUMENT):
            layers = opcount.explore_layers(layer, valid, n_vars)
            self._layers = (layers if self._layers is None
                            else self._layers + layers)
        self.explore_calls += 1
        self.explore_bytes += opcount.explore_bytes(
            int(layer.shape[0]), width=width, n_vars=n_vars)
        self.width = width

    # -- the wrappers --------------------------------------------------------

    def install(self) -> None:
        par, rf, hooks = self.parallel, self.rf, self
        launch, make_body, explore = (par.launch_runtime,
                                      par._make_worker_body,
                                      par.explore_batch)
        self.saved = {"launch_runtime": launch,
                      "_make_worker_body": make_body,
                      "explore_batch": explore}

        def launch_runtime(*a, **kw):
            with rf(LAUNCH_RUNTIME):
                rt = launch(*a, **kw)
            rt.attach_phase_probe()
            run_fused = rt.run_fused

            def traced_run_fused(*a, **kw):
                with rf(ROUNDS):
                    return run_fused(*a, **kw)

            rt.run_fused = traced_run_fused
            hooks.runtimes.append(rt)
            return rt

        def _make_worker_body(*a, **kw):
            body = make_body(*a, **kw)

            def traced_body(q, carry):
                with rf(WORKER_BODY):
                    return body(q, carry)

            return traced_body

        def explore_batch(subs, valid, weights, profits, *, width, n_vars):
            with rf(EXPLORE):
                out = explore(subs, valid, weights, profits, width=width,
                              n_vars=n_vars)
            hooks.note_explore(subs.layer, valid, width=width, n_vars=n_vars)
            return out

        par.launch_runtime = launch_runtime
        par._make_worker_body = _make_worker_body
        par.explore_batch = explore_batch

    def remove(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.parallel, name, fn)
        self.saved = {}

    def harvest(self) -> None:
        """Take the phase times of the rounds of the runtimes made since
        the last harvest, and let the runtimes go: the wrapped
        ``run_fused`` refers to its runtime, so it is taken off first, or
        each runtime's queues would wait for the cyclic collector."""
        for rt in self.runtimes:
            self.rounds.extend(
                {"worker_body": r.t_worker, "exchange": r.t_exchange}
                for r in rt.telemetry.rounds if r.phase_timed)
            del rt.run_fused
        self.runtimes.clear()

    def counts(self) -> dict:
        """The device counters, read once after the window."""
        def val(x):
            return None if x is None else int(x)
        layers = val(self._layers)
        ops = (None if layers is None
               else layers * opcount.ops_per_layer(self.width))
        return {"explore_calls": self.explore_calls,
                "explore_layers": layers, "explore_ops": ops,
                "explore_bytes": self.explore_bytes}

    def record(self) -> dict:
        """What the traced window adds to the record: each round's phase
        times and the counters."""
        return {"rounds": self.rounds, "counts": self.counts()}
