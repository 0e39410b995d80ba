"""Rank program of ``tests/test_torch_sharding.py``: the sharded-model path
(``launch.mesh.ModelMesh``, flash-decoding, expert-parallel MoE) on a
``(data 2, model 4)`` mesh of 8 ``gloo`` CPU ranks.

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

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import make_model_mesh, make_production_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.layers import P, ShardPlan
from repro_torch.models.zoo import build_model, params_from_numpy

CPU = torch.device("cpu")
MESH = ((2, 4), ("data", "model"))
N_RANKS = 8
# tests/test_perf_variants.py's flash-decoding setup: 16 prompts of 32
# tokens, the cache grown to 40, _SEQ_SHARD_MIN lowered to 16
FLASH = dict(batch=16, prompt=32, grow=40, seq_shard_min=16)
# ... and its EP setup: 8 experts of 64 -> 128, top-2, capacity 2.0
MOE = dict(E=8, D=64, F=128, k=2, capacity_factor=2.0)


def program(data: dict):
    return functools.partial(rank_main, data)


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


def rank_main(data: dict, rank: int) -> dict:
    mesh = make_model_mesh(*MESH, device="cpu")
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
    return out
