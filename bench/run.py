#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``repro_torch``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is a closed loop: one client
submits the instances of its traffic one after another to
``repro_torch.core.dd.parallel.parallel_solve``, each solve having the
whole card, for ``--seconds`` seconds after a set-up that builds or loads
the kernel library and solves one warm instance.  Once the window has
closed, every solve's optimum is compared with the plain dynamic program
in ``bench/reference``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, from a run under ``torch.profiler`` with the benchmark's
spans), ``device``, with ``--trace 1`` a ``breakdown``, and last the
numbers compared beside their limits (``checks``), which also end
standard error.

The run refuses, printing no result, without a CUDA device, with fewer
devices than the cell asks for, and when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded in a run: JAX and the JAX
# package this port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# switches of the program that change its path; a run takes its defaults
PROGRAM_SWITCHES = ("REPRO_QUEUE_BACKEND", "REPRO_CHECK", "REPRO_TRACE")
# caches of the program's toolchains, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".bench_cache/triton",
              "CUDA_CACHE_PATH": ".bench_cache/cuda"}


def use_checkout(root: Path = ROOT) -> None:
    """Import ``bench`` and ``repro_torch`` from the checkout at ``root``,
    with the program's switches at their defaults and the toolchains'
    caches inside the checkout (the program builds its kernel library
    into ``src/repro_torch/kernels/_build``, a path fixed in its code and
    inside the checkout too)."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for path in (root / "src", root):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    for name in PROGRAM_SWITCHES:
        os.environ.pop(name, None)
    for name, rel in CACHE_DIRS.items():
        os.environ[name] = str(root / rel)


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (by default the loaded
    modules') that are one of ``FORBIDDEN_MODULES``, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.partition(".")[0] for name in names}
                  & set(FORBIDDEN_MODULES))


def program_solver(config: dict, device):
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


def _card(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def _peak(kind: str):
    return json.loads((ROOT / "bench" / "peaks.json").read_text()).get(kind)


def _solve_window(solve, stream, seconds: float, *, max_steps: int,
                  max_solves=None, span=contextlib.nullcontext,
                  on_solve=None) -> list:
    """The closed loop: the next instance as soon as the last solve has
    returned, until ``seconds`` have passed (or ``max_solves`` solves),
    stopping at a solve that raised.  One record a solve."""
    from repro_torch.core.dd.knapsack import Knapsack

    solves = []
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline and len(solves) != max_solves:
        inst = next(stream)
        arg = Knapsack(inst.weights, inst.profits, inst.capacity)
        t = time.perf_counter()
        try:
            with span():
                opt, stats = solve(arg)
            error = None
        except Exception as exc:  # a solve that raised is a failed one
            opt, stats, error = None, {}, repr(exc)
        ms = (time.perf_counter() - t) * 1e3
        steps = stats.get("supersteps")
        solves.append({
            "inst": inst, "h": inst.h, "ms": ms, "optimum": opt,
            "error": error, "supersteps": steps,
            "transferred": stats.get("transferred"),
            "ok": error is None and steps is not None and steps < max_steps})
        if on_solve:
            on_solve()
        if error is not None:
            break
    return solves


def _check(solves: list) -> dict:
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


def run_cell(cell, seed: int, seconds: float, trace: int, *,
             device="cuda", solve=None, max_solves=None,
             record_out=None, t_start: float = T_START) -> dict:
    """One run of ``cell`` (a :class:`bench.cell.Cell`): set-up, the
    window, the check; returns the result line.  ``solve`` replaces the
    program (the control); ``device="cpu"`` rehearses on the CPU's plain
    versions; ``max_solves`` also closes the window after that many
    solves, so that a rehearsal solves the same instances however fast
    its host is.  ``record_out``, a dict, receives the run's record:
    every solve's time, counts and verdict."""
    import torch

    from bench import tracing, traffic
    from repro_torch.core.dd import parallel
    from repro_torch.core.dd.knapsack import Knapsack

    torch.set_num_threads(1)
    device = torch.device(device)
    cuda = device.type == "cuda"
    config, tr = cell.config, cell.traffic
    solve = solve or program_solver(config, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # -- set-up, each part timed: the device's context, the kernel
    # library (built at a checkout's first run), the instances drawn, the
    # warm solve (in a traced run under a first, thrown-away profile and
    # hooks: their start-up)
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    torch.zeros((), device=device)
    sync()
    parts["device_init"] = time.perf_counter() - t
    t = time.perf_counter()
    if cuda:
        from repro_torch.kernels import _lib

        _lib.library()
    parts["kernel_library"] = time.perf_counter() - t
    t = time.perf_counter()
    stream = traffic.instances(tr, config, seed)
    warm = traffic.warm_instance(tr, config, seed)
    warm = Knapsack(warm.weights, warm.profits, warm.capacity)
    parts["instances"] = time.perf_counter() - t
    t = time.perf_counter()
    hooks = None
    if trace:
        rf = torch.profiler.record_function
        profiled = functools.partial(tracing.profiled, cuda)
        span = functools.partial(rf, tracing.SOLVE)
        window_span = functools.partial(rf, tracing.WINDOW)
        hooks = tracing.Hooks(parallel, torch)
        hooks.install()
        with profiled():
            solve(warm)
            sync()
        hooks.harvest()
        hooks.remove()
        hooks = tracing.Hooks(parallel, torch)  # the window's own counts
        hooks.install()
    else:
        profiled = functools.partial(contextlib.nullcontext, {})
        span = window_span = contextlib.nullcontext
        solve(warm)
    sync()
    parts["warm_solve"] = time.perf_counter() - t
    for name, sec in parts.items():
        print(f"setup {name} {sec:.4f} s", file=sys.stderr, flush=True)

    # -- the window
    with profiled() as prof:
        with window_span():
            t0 = time.perf_counter()
            solves = _solve_window(
                solve, stream, seconds, max_solves=max_solves,
                max_steps=config["solver"]["max_supersteps"], span=span,
                on_solve=hooks and hooks.harvest)
            sync()
            window_s = time.perf_counter() - t0
    stop_s = time.perf_counter() - t0 - window_s
    card = _card(torch, device)

    # -- the record the metrics read, the trace's reduction with it
    record = {"setup_s": t0 - t_start, "window_s": window_s,
              "solves": solves}
    if hooks:
        hooks.remove()
        t = time.perf_counter()
        record.update(rounds=hooks.rounds, counts=hooks.counts(),
                      trace=tracing.reduce_trace(prof.pop("events")),
                      peak=_peak(card["kind"]))
        record["counts"].update(profile_stop_s=stop_s,
                                trace_reduce_s=time.perf_counter() - t)

    # -- the check, once the window has closed
    checks = _check(solves)
    metrics = {}
    for name, (unit, read) in cell.readers(trace).items():
        value = read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    line = {"correct": bool(solves) and all(c["value"] <= c["limit"]
                                            for c in checks.values()),
            "attempted": len(solves),
            "failed": sum(not (s["ok"] and s["right"]) for s in solves),
            "metrics": metrics, "device": card}
    if hooks:
        t = record["trace"]
        if t:
            card["busy_s"] = t["busy_s"]
            card["window_s"] = window_s
            line["breakdown"] = {"device_ops": t["top_device_ops"],
                                 "idle_gaps": t["idle_by_host"]}
        line["counts"] = {**record["counts"],
                          "rounds": len(record["rounds"]),
                          "unattributed_ops": t and t["unattributed_ops"],
                          "instrument_host_s": t and t["instrument_host_s"],
                          "explore_ops_by_name":
                              t and t["explore_ops_by_name"]}
    line["checks"] = checks
    if record_out is not None:
        record_out.update(record)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--pool-seed", type=int,
                    help="draw the pool's items from this seed instead of "
                    "the workload's own (a check of correctness on other "
                    "instances; no measurement uses it)")
    args = ap.parse_args(argv)
    use_checkout()
    from bench.cell import load_cell

    cell = load_cell(args.workload)
    if args.pool_seed is not None:
        cell.traffic = dict(cell.traffic, pool_seed=args.pool_seed)
    import torch

    if not torch.cuda.is_available():
        print("bench/run.py: no CUDA device; this benchmark measures the "
              "card and runs nowhere else", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench/run.py: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"bench/run.py: loaded modules that no run may load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
