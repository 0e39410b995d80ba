"""Multi-pod dry run: trace one rank's sharded step for every (arch x shape
x mesh) cell (port of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell's jitted step with GSPMD
shardings on 512 fake host devices and reads XLA's cost and memory
analysis.  torch has no GSPMD lowering; the port's counterpart is its own
sharded step (``with mesh.spmd():``, ``models.layers``), traced for rank 0
of the production mesh on ``meta`` tensors, with nothing allocated:

* ``trace_cell`` builds rank 0's blocks of the parameters, the optimizer
  state, the cache and the batch by their spec trees (``param_specs``,
  ``opt_state_specs``, ``cache_specs``, ``zoo.input_specs``) on a
  recording mesh (``launch.mesh.make_recording_mesh``) and runs the train
  step, prefill or decode once inside :class:`StepTrace`, a dispatch mode
  that counts each op's operations (``torch.utils.flop_counter``'s
  formulas) and input and output bytes and follows the peak of the bytes
  of the tensors the step makes.  The collectives are the recording
  mesh's log; K6 and K7 count at their own operations and bytes
  (``kernels.bounds``) and, on ``meta``, run nothing (their plain versions
  would count the logits K6 never forms).  The same trace around a real
  step on the CPU counts the same numbers.
* ``run_cell`` returns the JAX package's result schema, so both
  packages' reports render it: ``argument_bytes`` (the blocks the step
  takes), ``output_bytes`` (what it returns: the new parameters and
  optimizer state in training; the replicated logits and the cache in
  prefill and decode), ``alias_bytes`` (the donated parameters and
  optimizer state in training, the cache in decode), ``temp_bytes`` (the
  traced peak minus the arguments: every tensor the step makes, its
  outputs among them, so ``peak_bytes`` is arguments plus temporaries),
  and ``fits_hbm`` against the H100's memory (``HBM_BYTES``) where the
  JAX schema has ``fits_16g``; ``compile_s`` is the trace's seconds.
  A dimension that does not split is counted as GSPMD pads it,
  ``ceil(n / k)`` (``ModelMesh.block_shape``).

The JAX module's ``_cost_points`` / ``extrapolated_costs`` and
``--no-unroll`` have no counterpart (the flag is accepted and changes
nothing): XLA's cost analysis counts a ``while`` body once, so the JAX
package compiles unrolled variants and extrapolates; the port's layers
are a Python loop, so the trace counts every layer.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.kernels import bounds
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_recording_mesh
from repro_torch.models.zoo import build_model, input_specs, meta_init
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step

__all__ = ["model_flops_for", "cell_blocks", "argument_bytes", "trace_cell",
           "cell_result", "run_cell", "StepTrace", "HBM_BYTES",
           "production_mesh_shape", "main"]

# torch.cuda.get_device_properties(0).total_memory of the NVIDIA H100
# 80GB HBM3 the chip runs (chip_smoke.py's phase 15 prints it)
HBM_BYTES = 85_017_493_504


def production_mesh_shape(multi_pod: bool):
    """The JAX package's production mesh: ``(data 16, model 16)``, or
    ``(pod 2, data 16, model 16)``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train / 2*N*D inference (N_active for
    MoE; D = tokens processed)."""
    n = cfg.param_count()
    if cfg.n_experts:
        expert_p = 3 * cfg.d_model * cfg.d_ff_expert
        n -= cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert_p
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    return sum(_nbytes(x) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class StepTrace(TorchDispatchMode):
    """A dispatch mode over one traced step.  ``flops`` counts each op's
    operations (``torch.utils.flop_counter``'s formulas: the matrix
    products), ``bytes`` sums each op's input and output bytes (a view
    moves none), and a wrapper's kernel forward (``kernels.bounds
    .kernel``) counts at the kernel's own operations and bytes in place
    of whatever it dispatches (``kernels``: calls, operations and bytes
    per kernel).  ``peak`` is the largest total of the storages the step
    made that were alive at once (each followed by a weak reference to
    its storage, so a tensor autograd saved counts until it is freed)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak = 0
        self.kernels: Dict[str, list] = {}
        self._inside = 0

    def __enter__(self):
        bounds.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        bounds.SINKS.remove(self)
        return super().__exit__(*exc)

    def begin(self, name: str, ops: int, nbytes: int) -> None:
        if not self._inside:
            k = self.kernels.setdefault(name, [0, 0, 0])
            k[0] += 1
            k[1] += ops
            k[2] += nbytes
            self.flops += ops
            self.bytes += nbytes
        self._inside += 1

    def end(self) -> None:
        self._inside -= 1

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        if (not schema.is_mutable and schema.returns
                and all(r.alias_info is not None for r in schema.returns)):
            return out          # a view
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not self._inside:
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        grew = False
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live:
                self.live[key] = (StorageWeakRef(st), st.nbytes())
                self.live_bytes += st.nbytes()
                grew = True
        if grew and self.live_bytes > self.peak:
            self._sweep()       # exact only when it may be a new peak
            self.peak = max(self.peak, self.live_bytes)
        return out


def _meta_batch(sds: dict, ps: dict, mesh) -> dict:
    return {k: torch.empty(mesh.block_shape(s.shape, ps[k]), dtype=s.dtype,
                           device="meta") for k, s in sds.items()}


def cell_blocks(cfg: ModelConfig, shape: ShapeConfig, mesh,
                parallel: Optional[ParallelConfig]) -> Dict[str, Any]:
    """Rank ``mesh.rank``'s blocks of what the cell's step takes, on
    ``meta``: ``model``, ``params`` (by ``param_specs``), ``batch`` (by
    ``input_specs``), and ``opt`` (train: by ``opt_state_specs``) or
    ``cache`` (decode: by ``cache_specs``, its position at the last
    slot).  Sets ``mesh.batch_sharded`` as the batch's spec says."""
    model = build_model(cfg, parallel)
    out = {"model": model,
           "params": mesh.shard(meta_init(model), model.param_specs())}
    sds, ps = input_specs(cfg, shape, parallel)
    out["batch"] = _meta_batch(sds, ps, mesh)
    mesh.batch_sharded = mesh.size(ps["tokens"][0]) > 1
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out["opt"] = adamw_init(out["params"],
                                master_weights=cfg.param_dtype == "bfloat16")
    elif shape.kind == "decode":
        if cfg.family == "encdec":
            whole = model.make_cache(B, S, S, device="meta")
        else:
            whole = model.make_cache(B, S, device="meta")
        out["cache"] = model.cache_block(whole, mesh)
        out["cache"]["pos"] = S - 1
    return out


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   multi_pod: bool) -> Dict[str, int]:
    """Per-device bytes of rank 0's parameters, optimizer state (train),
    cache (decode) and batch on the production mesh."""
    mesh = make_recording_mesh(*production_mesh_shape(multi_pod))
    parallel = ParallelConfig(pod_axis="pod" if multi_pod else None)
    blocks = cell_blocks(cfg, shape, mesh, parallel)
    return {k: tree_bytes(blocks[k])
            for k in ("params", "opt", "cache", "batch") if k in blocks}


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               parallel: Optional[ParallelConfig]) -> Dict[str, Any]:
    """One traced step of the cell on ``mesh`` (a recording mesh: its log
    is cleared first): FLOPs, bytes, the collective log and the memory
    counts of that rank, as :func:`run_cell` reports them."""
    blocks = cell_blocks(cfg, shape, mesh, parallel)
    model, params, batch = blocks["model"], blocks["params"], blocks["batch"]
    logits_bytes = shape.global_batch * cfg.padded_vocab * 4  # replicated
    if shape.kind == "train":
        opt = blocks["opt"]
        step = make_train_step(model, AdamWConfig(
            master_weights=cfg.param_dtype == "bfloat16"))
        arg_bytes = tree_bytes((params, opt, batch))
        alias = tree_bytes((params, opt))

        def run():
            return step(params, opt, batch)
    elif shape.kind == "prefill":
        arg_bytes, alias = tree_bytes((params, batch)), 0
        lead = (batch["frames"],) if cfg.family == "encdec" else ()
        tail = (batch["patches"],) if cfg.family == "vlm" else ()

        def run():
            return model.prefill(params, *lead, batch["tokens"], *tail)
    else:
        cache = blocks["cache"]
        arg_bytes = tree_bytes((params, cache, batch["tokens"]))
        alias = tree_bytes(cache)

        def run():
            return model.decode_step(params, cache, batch["tokens"])
    mesh.log.clear()
    with mesh.spmd(), StepTrace() as tr:
        out = run()
    if shape.kind == "train":
        out_bytes = tree_bytes(out[:2]) + 4 * len(out[2])
    else:
        out_bytes = logits_bytes + tree_bytes(out[1])
    return {"flops": float(tr.flops),
            "bytes": float(tr.bytes), "records": list(mesh.log),
            "argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
            "alias_bytes": int(alias), "temp_bytes": int(tr.peak),
            "peak_bytes": int(arg_bytes + tr.peak),
            "kernels": {k: dict(calls=v[0], ops=v[1], bytes=v[2])
                        for k, v in tr.kernels.items()}}


def cell_result(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh,
                mesh_name: str, parallel: Optional[ParallelConfig],
                verbose: bool = False) -> Dict[str, Any]:
    """The JAX package's ``run_cell`` schema for one traced cell on
    ``mesh`` (a recording mesh of ``prod(shape)`` devices)."""
    n_devices = int(np.prod(list(mesh.shape.values())))
    t0 = time.time()
    tr = trace_cell(cfg, shape, mesh, parallel)
    dt = time.time() - t0
    mf = model_flops_for(cfg, shape)
    report = rf.analyze(arch=arch, shape=shape.name, mesh_name=mesh_name,
                        n_devices=n_devices, model_flops=mf,
                        flops=tr["flops"], nbytes=tr["bytes"],
                        records=tr["records"], memory=tr)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "compile_s": round(dt, 1),
        "memory_analysis": {
            "argument_bytes": tr["argument_bytes"],
            "output_bytes": tr["output_bytes"],
            "temp_bytes": tr["temp_bytes"],
            "alias_bytes": tr["alias_bytes"],
            "peak_bytes": tr["peak_bytes"],
            "fits_hbm": tr["peak_bytes"] <= HBM_BYTES,
        },
        "cost_analysis": {
            "flops_per_device": report.flops_per_device,
            "bytes_per_device": report.bytes_per_device,
        },
        "collectives": dict(report.collective_breakdown),
        "collective_bytes_per_device": report.collective_bytes_per_device,
        "roofline": report.terms(),
        "bottleneck": report.bottleneck,
        "model_flops": mf,
        "useful_ratio": report.useful_ratio,
    }
    if verbose:
        GiB = 2 ** 30
        print(f"[{arch} x {shape.name} x {mesh_name}] trace={dt:.1f}s "
              f"mem(arg/temp/out)={tr['argument_bytes'] / GiB:.2f}/"
              f"{tr['temp_bytes'] / GiB:.2f}/"
              f"{tr['output_bytes'] / GiB:.2f} GiB  "
              f"terms(c/m/x)={report.compute_s * 1e3:.2f}/"
              f"{report.memory_s * 1e3:.2f}/"
              f"{report.collective_s * 1e3:.2f} ms  "
              f"bottleneck={report.bottleneck}", flush=True)
    return result


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, unroll_costs: bool = True,
             variant: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """The JAX package's ``run_cell`` result for one cell, from
    :func:`trace_cell` on rank 0 of the production mesh
    (``unroll_costs`` is accepted and changes nothing: see the module
    docstring)."""
    del unroll_costs
    cfg = configs.get(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
    shape = next(s for s in configs.SHAPES if s.name == shape_name)
    mesh = make_recording_mesh(*production_mesh_shape(multi_pod))
    return cell_result(arch, cfg, shape, mesh,
                       "2x16x16" if multi_pod else "16x16",
                       ParallelConfig(pod_axis="pod" if multi_pod else None),
                       verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--no-unroll", action="store_true",
                    help="accepted for the JAX CLI's sake; the trace "
                         "counts every layer either way")
    ap.add_argument("--moe-impl", default=None,
                    choices=["gspmd", "ep_shardmap"],
                    help="override MoE dispatch impl (perf variant)")
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override param dtype (bf16 => master weights)")
    ap.add_argument("--moe-bulk-steal", default=None, choices=["on", "off"],
                    help="override the bulk-steal rebalancing (ablation)")
    args = ap.parse_args(argv)

    variant: Dict[str, Any] = {}
    if args.moe_impl:
        variant["moe_impl"] = args.moe_impl
    if args.param_dtype:
        variant["param_dtype"] = args.param_dtype
    if args.moe_bulk_steal:
        variant["moe_bulk_steal"] = args.moe_bulk_steal == "on"

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    failures = 0

    def _flush():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    for arch in archs:
        cfg = configs.get(arch)
        cells = configs.cells_for(cfg)
        shapes = ([s.name for s in cells] if args.shape == "all"
                  else [args.shape])
        for shape_name in shapes:
            if shape_name not in [s.name for s in cells]:
                print(f"[{arch} x {shape_name}] SKIP (inapplicable; see "
                      f"DESIGN.md long_500k rule)")
                continue
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape_name, mp,
                                            variant=variant or None))
                except Exception as e:  # record the failure, keep sweeping
                    failures += 1
                    traceback.print_exc()
                    results.append({
                        "arch": arch, "shape": shape_name,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                    })
                _flush()
    _flush()
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n== dry-run complete: {ok} ok / {failures} failed "
          f"-> {args.out} ==")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
