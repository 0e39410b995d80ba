#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``repro_torch``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is a closed loop: one client
calls the program on the items of its traffic one after another, each
call having the whole card, for ``--seconds`` seconds after a set-up that
builds or loads the kernel library and makes one warm call.  Once the
window has closed, every call's output is checked against a plain
reference.  What the program is, what its items are and how its outputs
are checked is the cell's kind (its configuration's ``"kind"``): the
module ``bench/kinds/<kind, '-' as '_'>.py``, which this file names
nowhere.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones,
from a run under ``torch.profiler`` with the benchmark's spans),
``device``, with ``--trace 1`` a ``breakdown``, and last the numbers
compared beside their limits (``checks``), which also end standard
error.

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


def _window(kind, config, program, stream, seconds: float, *,
            max_solves=None, span=contextlib.nullcontext,
            on_call=None) -> list:
    """The closed loop: the next item as soon as the last call has
    returned, until ``seconds`` have passed (or ``max_solves`` calls),
    stopping at a call that raised.  One record a call, made by the
    kind."""
    calls = []
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline and len(calls) != max_solves:
        item = next(stream)
        arg = kind.argument(item)
        t = time.perf_counter()
        try:
            with span():
                out = program(arg)
            error = None
        except Exception as exc:  # a call that raised is a failed one
            out, error = None, repr(exc)
        ms = (time.perf_counter() - t) * 1e3
        calls.append(kind.record(config, item, out, ms, error))
        if on_call:
            on_call()
        if error is not None:
            break
    return calls


def run_cell(cell, seed: int, seconds: float, trace: int, *,
             device="cuda", program=None, max_solves=None,
             record_out=None, t_start: float = T_START) -> dict:
    """One run of ``cell`` (a :class:`bench.cell.Cell`): set-up, the
    window, the check; returns the result line.  What is run, on what,
    and how it is checked comes from the cell's kind
    (``bench/kinds/<kind>.py``: ``program``, ``items``, ``warm_item``,
    ``argument``, ``record``, ``check``, ``Hooks``).  ``program``
    replaces the kind's program (the control); ``device="cpu"`` rehearses
    on the CPU's plain versions; ``max_solves`` also closes the window
    after that many calls, so that a rehearsal calls on the same items
    however fast its host is.  ``record_out``, a dict, receives the run's
    record: every call's time, counts and verdict."""
    import torch

    from bench import tracing

    torch.set_num_threads(1)
    device = torch.device(device)
    cuda = device.type == "cuda"
    kind, config, tr = cell.kind, cell.config, cell.traffic
    program = program or kind.program(config, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # -- set-up, each part timed: the device's context, the kernel
    # library (built at a checkout's first run), the items drawn, the
    # warm call (in a traced run under a first, thrown-away profile and
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
    stream = kind.items(tr, config, seed)
    warm = kind.argument(kind.warm_item(tr, config, seed))
    parts["items"] = time.perf_counter() - t
    t = time.perf_counter()
    hooks = None
    if trace:
        rf = torch.profiler.record_function
        profiled = functools.partial(tracing.profiled, cuda)
        span = functools.partial(rf, tracing.SOLVE)
        window_span = functools.partial(rf, tracing.WINDOW)
        hooks = kind.Hooks(torch)
        hooks.install()
        with profiled():
            program(warm)
            sync()
        hooks.harvest()
        hooks.remove()
        hooks = kind.Hooks(torch)  # the window's own counts
        hooks.install()
    else:
        profiled = functools.partial(contextlib.nullcontext, {})
        span = window_span = contextlib.nullcontext
        program(warm)
    sync()
    parts["warm_call"] = time.perf_counter() - t
    for name, sec in parts.items():
        print(f"setup {name} {sec:.4f} s", file=sys.stderr, flush=True)

    # -- the window
    with profiled() as prof:
        with window_span():
            t0 = time.perf_counter()
            calls = _window(kind, config, program, stream, seconds,
                             max_solves=max_solves, span=span,
                             on_call=hooks and hooks.harvest)
            sync()
            window_s = time.perf_counter() - t0
    stop_s = time.perf_counter() - t0 - window_s
    card = _card(torch, device)

    # -- the record the metrics read, the trace's reduction with it
    # (every kind's records are under "solves", which the readers read)
    record = {"setup_s": t0 - t_start, "window_s": window_s,
              "solves": calls}
    if hooks:
        hooks.remove()
        t = time.perf_counter()
        record.update(hooks.record(),
                      trace=tracing.reduce_trace(
                          prof.pop("events"), spans=hooks.SPANS,
                          kernels=hooks.KERNELS),
                      peak=_peak(card["kind"]))
        record.setdefault("counts", {}).update(
            profile_stop_s=stop_s, trace_reduce_s=time.perf_counter() - t)

    # -- the check, once the window has closed
    checks = kind.check(calls)
    metrics = {}
    for name, (unit, read) in cell.readers(trace).items():
        value = read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    line = {"correct": bool(calls) and all(c["value"] <= c["limit"]
                                           for c in checks.values()),
            "attempted": len(calls),
            "failed": sum(not (c["ok"] and c["right"]) for c in calls),
            "metrics": metrics, "device": card}
    if hooks:
        t = record["trace"]
        if t:
            card["busy_s"] = t["busy_s"]
            card["window_s"] = window_s
            line["breakdown"] = {"device_ops": t["top_device_ops"],
                                 "idle_gaps": t["idle_by_host"]}
        line["counts"] = {
            **record["counts"], "rounds": len(record.get("rounds", ())),
            "unattributed_ops": t and t["unattributed_ops"],
            "instrument_host_s": t and t["instrument_host_s"],
            **{f"{k}_ops_by_name": t and t[f"{k}_ops_by_name"]
               for k in hooks.KERNELS}}
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
    ap.add_argument("--traffic", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a traffic parameter of the workload replaced by "
                    "a JSON value, e.g. pool_seed=7 (a check of correctness "
                    "on other items; no measurement uses it)")
    args = ap.parse_args(argv)
    use_checkout()
    from bench.cell import load_cell

    cell = load_cell(args.workload)
    for kv in args.traffic:
        key, _, value = kv.partition("=")
        cell.traffic = dict(cell.traffic, **{key: json.loads(value)})
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
