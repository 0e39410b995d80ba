"""Rank program of ``tests/test_torch_sharding.py``: the sharded-model path
(``launch.mesh.ModelMesh``, flash-decoding, expert-parallel MoE) and the
sharded step (``with mesh.spmd():``: train, prefill and decode, and the
dry run's trace of the same step) on a ``(data 2, model 4)`` mesh of 8
``gloo`` CPU ranks, and one train step on a ``(pod 2, data 2, model 2)``
mesh of the same ranks.

Imports neither JAX nor the JAX package, so that spawned ranks load only
torch and the port: the JAX package's parameters and inputs arrive as
numpy arrays, and each rank returns numpy results (its rows' logits, its
cache slice, how often each body ran) for the test to hold against the
JAX package's unsharded functions.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

import numpy as np

from repro_torch import configs
from repro_torch._tree import tree_map
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_model_mesh, make_production_mesh,
                                     make_recording_mesh)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.layers import P, ShardPlan
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import (make_train_step, sync_grads,
                                       value_and_grad)

CPU = torch.device("cpu")
MESH = ((2, 4), ("data", "model"))
N_RANKS = 8
# tests/test_perf_variants.py's flash-decoding setup: 16 prompts of 32
# tokens, the cache grown to 40, _SEQ_SHARD_MIN lowered to 16
FLASH = dict(batch=16, prompt=32, grow=40, seq_shard_min=16)
# ... and its EP setup: 8 experts of 64 -> 128, top-2, capacity 2.0
MOE = dict(E=8, D=64, F=128, k=2, capacity_factor=2.0)


# The sharded step: reduced archs (float32), 16 rows of 32 tokens, one
# AdamW step (eps 1e-6: at 1e-8 a gradient element near 1e-9, which two
# computations round apart, moves its weight by a different share of lr).
# "qwen3-moe-ep" is qwen3-moe with 16 experts, which param_specs lays out
# over the model axis (experts % 16 == 0); the reduced 8 split d_ff.
STEP = dict(batch=16, seq=32)
STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)
STEP_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "qwen3-moe-ep",
              "mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium")
PREFILL_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
                 "zamba2-7b", "seamless-m4t-medium")
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))


def step_arch(name: str):
    """(registry arch, config changes) of a sharded-step case."""
    if name == "qwen3-moe-ep":
        return "qwen3-moe-30b-a3b", {"n_experts": 16}
    return name, {}


def step_batch(cfg, seed: int = 3) -> dict:
    """The case's numpy batch: tokens and labels (16, 32) int32, and the
    family's frames."""
    rng = np.random.default_rng(seed)
    B, S = STEP["batch"], STEP["seq"]
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    return out


def program(path: str):
    """The rank function over the inputs pickled at ``path``: a spawned
    rank's arguments travel through a pipe the parent fills one rank at
    a time, so inputs past the pipe's buffer would start the ranks one
    after another."""
    return functools.partial(_load_and_run, path)


def _load_and_run(path: str, rank: int) -> dict:
    import pickle
    with open(path, "rb") as f:
        return rank_main(pickle.load(f), rank)


class _Counted:
    """Counts the calls of a module function that did not return None."""

    def __init__(self, mod, name):
        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.taken = 0
        setattr(mod, name, self)

    def __call__(self, *a, **kw):
        out = self.real(*a, **kw)
        self.taken += out is not None
        return out


def _np(x):
    return x.detach().float().numpy()


def _cfg(arch, **changes):
    return dataclasses.replace(configs.reduced(configs.get(arch)),
                               compute_dtype="float32", **changes)


def _decode(mesh, arch, data, grow, rows):
    """Prefill this data rank's rows, grow the cache to ``grow``, keep this
    model rank's slice (``shard_cache``) and decode two steps under the
    mesh; returns both steps' logits, the cache layout and the bodies'
    call counts."""
    cfg = _cfg(arch, decode_impl="flash_shardmap")
    model = build_model(cfg, ParallelConfig())
    params = params_from_numpy(data[f"{arch}/params"], CPU)
    toks = torch.from_numpy(data[f"{arch}/tokens"][rows])
    S = FLASH["prompt"]
    _, cache = model.prefill(params, toks[:, :S])
    cache = model.grow_cache(cache, grow)
    local = model.shard_cache(cache, mesh)
    flash = _Counted(attn_mod, "decode_attention_shardmap")
    try:
        with mesh:
            lg1, local = model.decode_step(params, local, toks[:, S:S + 1])
            lg2, local = model.decode_step(params, local,
                                           toks[:, S + 1:S + 2])
    finally:
        setattr(attn_mod, "decode_attention_shardmap", flash.real)
    layers = [g for g in local if g.startswith("g")]
    return {"logits": [_np(lg1), _np(lg2)],
            "seq_len": {g: local[g].get("seq_len") for g in layers},
            "cache_shapes": {g: list(local[g]["k"].shape) for g in layers},
            "flash_calls": flash.taken, "pos": local["pos"],
            "g0_k": _np(local["g0"]["k"])}


def _moe(mesh, data, E, rows):
    """``moe_apply(impl="ep_shardmap")`` on this data rank's rows, each
    model rank holding its E / 4 experts when they divide (else all)."""
    p = params_from_numpy(data[f"moe{E}/params"], CPU)
    x = torch.from_numpy(data[f"moe{E}/x"][rows])
    if E % mesh.shape["model"] == 0:
        spec = P("model")
        p = mesh.shard(p, {"router": None, "w_gate": spec, "w_up": spec,
                           "w_down": spec})
    ep = _Counted(moe_mod, "moe_apply_ep_shardmap")
    try:
        with mesh:
            out = moe_mod.moe_apply(
                p, x, top_k=MOE["k"], n_experts=E,
                capacity_factor=MOE["capacity_factor"],
                compute_dtype=torch.float32, impl="ep_shardmap",
                sh=ShardPlan())
    finally:
        setattr(moe_mod, "moe_apply_ep_shardmap", ep.real)
    return {"out": _np(out), "ep_calls": ep.taken,
            "experts_held": int(p["w_gate"].shape[0])}


def _moe_prefill(mesh, data, rows):
    """Reduced qwen3-moe with ``moe_impl="ep_shardmap"``: ``shard_params``
    keeps this model rank's experts, and the prefill of this data rank's
    rows runs every MoE layer through the EP body."""
    cfg = _cfg("qwen3-moe-30b-a3b", moe_impl="ep_shardmap")
    model = build_model(cfg, ParallelConfig())
    params = params_from_numpy(data["qwen3-moe-30b-a3b/params"], CPU)
    local = model.shard_params(params, mesh)
    toks = torch.from_numpy(data["qwen3-moe-30b-a3b/tokens"][rows])
    ep = _Counted(moe_mod, "moe_apply_ep_shardmap")
    try:
        with mesh:
            logits, _ = model.prefill(local, toks)
    finally:
        setattr(moe_mod, "moe_apply_ep_shardmap", ep.real)
    return {"logits": _np(logits), "ep_calls": ep.taken,
            "experts_held": int(local["blocks"]["g0"]["moe"]["w_gate"]
                                .shape[1])}


def _round_trip(mesh, data) -> dict:
    """``shard`` then ``gather`` of reduced llama's parameters by its
    ``param_specs``, and of a batch-8 cache by ``cache_specs`` (the
    sequence over data and model together): the same tree back."""
    model = build_model(_cfg("llama3.2-1b"), ParallelConfig())
    params = params_from_numpy(data["llama3.2-1b/params"], CPU)
    specs = model.param_specs()
    local = mesh.shard(params, specs)
    back = mesh.gather(local, specs)
    cache = model.make_cache(8, 40, device=CPU)
    gen = torch.Generator().manual_seed(1)  # the same tree on every rank
    for kv in ("k", "v"):
        cache["g0"][kv].normal_(generator=gen)
    cspecs = model.cache_specs(40, batch=8)
    clocal = mesh.shard(cache, cspecs)
    cback = mesh.gather(clocal, cspecs)
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves(params), _leaves(back)))
    cache_same = all(torch.equal(a, b) for a, b in zip(
        _leaves(cache), _leaves(cback)))
    return {"params_equal": same, "cache_equal": cache_same,
            "embed_local": list(local["embed"].shape),
            "cache_local": list(clocal["g0"]["k"].shape)}


def _leaves(tree):
    from repro_torch._tree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _refusals(mesh, data) -> dict:
    """Where the bodies return None, as the JAX package's do."""
    cfg = _cfg("gemma2-9b")
    model = build_model(cfg)
    local_cfg = transformer._attn_cfg(cfg, local=True)
    global_cfg = transformer._attn_cfg(cfg, local=False)
    pl = params_from_numpy(data["gemma2-9b/params"], CPU)
    pl = {k: v[0] for k, v in pl["blocks"]["g1"]["attn"].items()}
    x = torch.zeros((2, 1, cfg.d_model))
    ck = torch.zeros((2, 10, cfg.n_kv_heads, cfg.hd))
    body = attn_mod.decode_attention_shardmap
    out = {"no_mesh": body(pl, x, ck, ck.clone(), 3, global_cfg,
                           model.sh, torch.float32) is None}
    with mesh:
        out["window"] = body(pl, x, ck, ck.clone(), 3, local_cfg, model.sh,
                             torch.float32) is None
        out["c_mod_tp"] = body(pl, x, ck, ck.clone(), 3, global_cfg,
                               model.sh, torch.float32, seq_len=42) is None
        out["taken"] = body(pl, x, ck, ck.clone(), 3, global_cfg, model.sh,
                            torch.float32) is not None
    try:
        make_production_mesh(device="cpu")
    except ValueError as e:
        out["production_mesh"] = str(e)
    return out


def _rows(mesh, batch: dict, sh) -> dict:
    """This rank's rows of a batch split over the plan's batch axes."""
    entry = tuple(a for a in sh.dp if a in mesh.shape)
    n, i = mesh.size(entry), mesh.index(entry)
    return {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


class _Plans:
    """Records every routing plan (expert, slot, valid) computed."""

    def __init__(self):
        self.real, self.plans = moe_mod.route_with_bulk_steal, []
        moe_mod.route_with_bulk_steal = self

    def __call__(self, *a, **kw):
        out = self.real(*a, **kw)
        self.plans.append([_np(out[i]).astype(np.int64) if i != 3
                           else out[i].numpy() for i in (0, 1, 3)])
        return out

    def close(self):
        moe_mod.route_with_bulk_steal = self.real


def _sharded_step(mesh, name: str, data: dict, *, trace: bool) -> dict:
    """One sharded train step of case ``name`` on this rank's blocks: the
    loss and metrics on every rank, and on rank 0 the gathered gradient
    (``value_and_grad`` and ``sync_grads`` under the mesh) and the
    gathered parameters after the step; with ``trace`` its
    ``dryrun.StepTrace`` FLOPs and collective log beside ``trace_cell``'s
    on a recording mesh at rank 0's coordinates; for an MoE case the
    routing plans of a forward, sharded and unsharded."""
    arch, changes = step_arch(name)
    cfg = _cfg(arch, **changes)
    pod = "pod" in mesh.shape
    model = build_model(cfg, ParallelConfig(pod_axis="pod" if pod else None))
    specs = model.param_specs()
    full = params_from_numpy(data[f"step/{name}/params"], CPU)
    local = mesh.shard(full, specs)
    whole = _tensors(data[f"step/{name}/batch"])
    batch = _rows(mesh, whole, model.sh)
    step = make_train_step(model, AdamWConfig(**STEP_OPT))
    log = mesh.record()
    with mesh.spmd(), dryrun.StepTrace() as tr:
        new, _, met = step(local, adamw_init(local), batch)
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "flops": tr.flops, "kernels": tr.kernels}
    if trace:
        out["log"] = list(log)
        shape = ShapeConfig("step", STEP["seq"], STEP["batch"], "train")
        rec = make_recording_mesh(tuple(mesh.shape.values()),
                                  tuple(mesh.shape), rank=0)
        t = dryrun.trace_cell(cfg, shape, rec, ParallelConfig(
            pod_axis="pod" if pod else None))
        out["trace"] = {"flops": t["flops"], "log": t["records"]}
    with mesh.spmd():
        _, grads = value_and_grad(model.loss_fn, local, batch)
        grads = sync_grads(grads, specs, model.sh)
    grads, new = mesh.gather(grads, specs), mesh.gather(new, specs)
    if mesh.rank == 0:
        out["grads"] = tree_map(_np, grads)
        out["params"] = tree_map(_np, new)
    if cfg.n_experts:
        taps = _Plans()
        try:
            with torch.no_grad():
                model.loss_fn(full, whole)
                n = len(taps.plans)
                with mesh.spmd():
                    model.loss_fn(local, batch)
        finally:
            taps.close()
        out["plans_equal"] = len(taps.plans) == 2 * n and all(
            all(np.array_equal(a, b) for a, b in zip(u, s_))
            for u, s_ in zip(taps.plans[:n], taps.plans[n:]))
        out["plans"] = n
    return out


def _strip(cache) -> dict:
    """A cache's tensors as numpy (the recorded lengths dropped)."""
    if isinstance(cache, dict):
        return {k: _strip(v) for k, v in cache.items() if k != "seq_len"}
    return _np(cache) if isinstance(cache, torch.Tensor) else cache


def _sharded_prefill(mesh, name: str, data: dict) -> dict:
    """The sharded prefill of this rank's rows: its logits and its cache
    blocks (``cache_specs``' layout)."""
    arch, changes = step_arch(name)
    cfg = _cfg(arch, **changes)
    model = build_model(cfg, ParallelConfig())
    local = mesh.shard(params_from_numpy(data[f"step/{name}/params"], CPU),
                       model.param_specs())
    batch = _tensors(_rows(mesh, data[f"step/{name}/batch"], model.sh))
    with mesh.spmd():
        if cfg.family == "encdec":
            logits, cache = model.prefill(local, batch["frames"],
                                          batch["tokens"])
        else:
            logits, cache = model.prefill(local, batch["tokens"])
    return {"logits": _np(logits), "cache": _strip(cache)}


def _sharded_decode(mesh, data: dict) -> dict:
    """A llama decode step in the sharded step: the whole cache of the
    unsharded prefill of all 16 prompts, grown to 40 positions, cut to
    this rank's block by ``cache_block`` (the sequence split over the
    model axis, ``_SEQ_SHARD_MIN`` lowered to 16), then one step of this
    rank's rows against it."""
    cfg = _cfg("llama3.2-1b")
    model = build_model(cfg, ParallelConfig())
    params = params_from_numpy(data["llama3.2-1b/params"], CPU)
    toks = torch.from_numpy(data["llama3.2-1b/tokens"])
    S = FLASH["prompt"]
    _, cache = model.prefill(params, toks[:, :S])
    cache = model.cache_block(model.grow_cache(cache, FLASH["grow"]), mesh)
    rows = _rows(mesh, {"t": toks[:, S:S + 1]}, model.sh)["t"]
    with mesh.spmd():
        logits, cache = model.decode_step(
            mesh.shard(params, model.param_specs()), cache, rows)
    return {"logits": _np(logits), "seq_len": cache["g0"]["seq_len"],
            "cache_positions": int(cache["g0"]["k"].shape[2])}


def rank_main(data: dict, rank: int) -> dict:
    mesh = make_model_mesh(*MESH, device="cpu")
    pods = make_model_mesh(*POD_MESH, device="cpu")
    d = mesh.coords["data"]
    B = FLASH["batch"] // mesh.shape["data"]
    rows = slice(d * B, (d + 1) * B)
    transformer._SEQ_SHARD_MIN = FLASH["seq_shard_min"]
    out = {"coords": dict(mesh.coords), "round_trip": _round_trip(mesh, data)}
    out["llama"] = _decode(mesh, "llama3.2-1b", data, FLASH["grow"], rows)
    out["llama_c_mod_tp"] = _decode(mesh, "llama3.2-1b", data, 42, rows)
    out["gemma2"] = _decode(mesh, "gemma2-9b", data, FLASH["grow"], rows)
    xrows = slice(d * 2, (d + 1) * 2)
    out["moe8"] = _moe(mesh, data, 8, xrows)
    out["moe6"] = _moe(mesh, data, 6, xrows)
    out["qwen3"] = _moe_prefill(mesh, data, slice(d * 2, (d + 1) * 2))
    out["refusals"] = _refusals(mesh, data)
    out["step"] = {name: _sharded_step(mesh, name, data,
                                       trace=name in ("llama3.2-1b",
                                                      "mamba2-2.7b"))
                   for name in STEP_ARCHS}
    out["prefill"] = {name: _sharded_prefill(mesh, name, data)
                      for name in PREFILL_ARCHS}
    out["decode"] = _sharded_decode(mesh, data)
    out["pod_step"] = _sharded_step(pods, "llama3.2-1b", data, trace=True)
    out["pod_coords"] = dict(pods.coords)
    return out
