"""Render the dry run's JSON as the §Dry-run and §Roofline sections, and
the observability gate's results as §Observability (port of
``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.json \\
      [OBS.json]

The observability section renders only when an obs JSON is named (the
second argument, an explicit path: there is no default file): a dict in
the ``obs_overhead`` schema of the JAX package's ``benchmarks/run.py
--obs`` (the probe overhead, its limit and gates, and per execution mode
the timed rounds and each phase's fraction), which ``chip_smoke.py``'s
phase 14 results (``overhead_ratio``, ``phase_fractions``) fill.
"""

from __future__ import annotations

import json
import sys
from typing import List

GiB = 2 ** 30


def _f(x, nd=1):
    return f"{x:.{nd}f}"


def _fits(ma: dict) -> bool:
    return bool(ma.get("fits_hbm", ma.get("fits_16g")))


def dryrun_section(results: List[dict]) -> str:
    lines = [
        "## §Dry-run",
        "",
        "Every (arch × shape × mesh) cell's sharded step traced for rank 0",
        "on `meta` tensors (no allocation; `launch/dryrun.py`). `trace s`",
        "is the trace's time; `mem/dev` is the traced peak per device",
        "(arguments + every tensor the step makes); the fit budget is the",
        "NVIDIA H100's 80 GB HBM3 (`torch.cuda.get_device_properties`'",
        "`total_memory`). Collective volumes are per-device wire bytes",
        "(ring formulas over the recorded collective log; table in",
        '§Roofline). Multi-pod cells prove the "pod" axis shards (DP',
        "across pods, params replicated per pod, grads all-reduced over",
        "the pods once per step).",
        "",
        "| arch | shape | mesh | trace s | args GiB | temps GiB | out GiB | peak GiB | fits 80G |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR: "
                f"{r.get('error', '?')[:60]} | | | | | |")
            continue
        ma = r["memory_analysis"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']} | {_f(ma['argument_bytes']/GiB, 2)} | "
            f"{_f(ma['temp_bytes']/GiB, 2)} | "
            f"{_f(ma['output_bytes']/GiB, 2)} | "
            f"{_f(ma['peak_bytes']/GiB, 2)} | "
            f"{'Y' if _fits(ma) else 'N'} |")
    ok = sum(1 for r in results if r.get("status") == "ok")
    lines += ["", f"**{ok}/{len(results)} cells trace.**", ""]
    return "\n".join(lines)


def roofline_section(results: List[dict]) -> str:
    lines = [
        "## §Roofline",
        "",
        "Single-pod (16×16 = 256 GPUs) per-device terms of rank 0's traced",
        "step: every layer counted (the port's layers are a Python loop, so",
        "nothing is extrapolated).",
        "",
        "- compute = FLOPs/dev ÷ 989 TF/s (H100 SXM dense bf16) · memory =",
        "  bytes/dev ÷ 3.35 TB/s (H100 HBM3) · collective = wire_bytes/dev",
        "  ÷ 50 GB/s (one 400 Gb/s NDR InfiniBand adapter per GPU).",
        "- `useful` = MODEL_FLOPS (6·N·D train / 2·N·D inference,",
        "  N_active for MoE) ÷ (FLOPs/dev × 256). The gap is attention",
        "  quadratics, remat recompute, the plain attention backward and",
        "  the MoE expert buffers each data rank computes whole.",
        "- CAVEAT: bytes/dev sums every dispatched op's inputs and outputs",
        "  (K6 and K7 at their own counts), with no fusion — an unfused",
        "  UPPER bound and a relative metric between variants, not an H100",
        "  wall-clock prediction.",
        "",
        "| arch | shape | compute ms | memory ms | collective ms | bottleneck | useful | ag/ar/rs/a2a/cp MB |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r.get("status") != "ok" or r.get("mesh") != "16x16":
            continue
        rt = r["roofline"]
        cb = r.get("collectives", {})
        mb = "/".join(
            f"{cb.get(k, 0)/2**20:.0f}"
            for k in ("all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_f(rt['compute_s']*1e3)} | "
            f"{_f(rt['memory_s']*1e3)} | {_f(rt['collective_s']*1e3)} | "
            f"{r['bottleneck']} | {_f(r['useful_ratio'], 3)} | {mb} |")
    lines.append("")
    return "\n".join(lines)


def obs_section(bench: dict) -> str:
    """§Observability from an ``obs_overhead``-schema dict: the
    phase-probe gate results and the per-phase split per execution
    mode."""
    obs = bench["obs_overhead"]
    lines = [
        "## §Observability",
        "",
        "Phase-probe contract on the fused Fig. 9 drain: overhead is the",
        "median paired probed/unprobed wall ratio; bit-identity and",
        "launch-count identity are exact checks.",
        "",
        f"- probe overhead {obs['probe_overhead']:.3f}x"
        f" (budget < {obs['overhead_limit']:g}x)"
        f" — gates {'ALL PASS' if obs['gates_ok'] else 'FAILING'}:"
        f" {', '.join(k for k, v in obs['gates'].items() if not v) or 'none failing'}",
        "",
        "| mode | rounds | worker_body | exchange | splice | adaptive |",
        "|---|---|---|---|---|---|",
    ]
    for mode, d in obs.get("phase_breakdown", {}).items():
        fr = d.get("phases", {})
        cells = " | ".join(
            f"{fr[p]['fraction']:.0%}" if p in fr else "-"
            for p in ("worker_body", "exchange", "splice",
                      "adaptive_update"))
        lines.append(f"| {mode} | {d['timed_rounds']} | {cells} |")
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "results/dryrun.json"
    with open(path) as f:
        results = json.load(f)
    print(dryrun_section(results))
    print()
    print(roofline_section(results))
    if len(argv) > 1:
        with open(argv[1]) as f:
            print()
            print(obs_section(json.load(f)))


if __name__ == "__main__":
    main()
