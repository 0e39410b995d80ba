"""The port's MoE (``repro_torch.models.moe``) against the JAX package's on
the CPU.

The routing plan (expert, slot, valid) is integer arithmetic and must be
bit-equal to ``repro.models.moe.route_with_bulk_steal`` for the same
router probabilities: skewed ones that overflow experts, and rows of
exactly tied probabilities (``lax.top_k`` takes the lower expert).  The
combine weight is float32 and must agree to 1e-6.  ``moe_apply`` and the
MoE models' prefill and decode compute in float32 and must agree to
``atol = rtol = 1e-4`` (the port's float32 logits tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models.layers import ShardPlan
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.zoo import build_model, params_from_numpy

from _torch_parity import assert_same, one_torch_thread, tree_np  # noqa: F401

CPU = torch.device("cpu")
PLAN_TOL = 1e-6
F32_TOL = 1e-4


def _probs(rng, T, E, kind):
    """(T, E) float32 router probabilities: ``skewed`` (a softmax with a
    few favoured experts, so that some overflow) or ``tied`` (small
    integers over their row sum: many exactly equal entries, whole rows
    uniform among them)."""
    if kind == "skewed":
        logits = rng.standard_normal((T, E)).astype(np.float32) * 2.0
        logits[:, : max(E // 4, 1)] += 3.0
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    ints = rng.integers(1, 4, (T, E)).astype(np.float32)
    ints[::5] = 1.0                                    # uniform rows
    return (ints / ints.sum(-1, keepdims=True)).astype(np.float32)


CASES = [(T, E, k) for T in (16, 64, 257) for E in (4, 8, 128)
         for k in (1, 2, 8) if k <= E]


@pytest.mark.parametrize("T,E,k", CASES)
def test_routing_plan_is_bit_equal_to_the_jax_package(T, E, k):
    rng = np.random.default_rng(T * 1000 + E * 10 + k)
    for kind in ("skewed", "tied"):
        probs = _probs(rng, T, E, kind)
        for cf in (1.0, 1.25):
            caps = {moe.capacity_of(T, k, E, cf), max(int(T * k / E * cf), k)}
            for cap in sorted(caps):
                for steal in (False, True):
                    what = f"{kind} cf={cf} cap={cap} steal={steal}"
                    want = jmoe.route_with_bulk_steal(
                        jnp.asarray(probs), k, cap, bulk_steal=steal)
                    got = moe.route_with_bulk_steal(
                        torch.from_numpy(probs), k, cap, bulk_steal=steal)
                    for name, w, g in zip(("expert", "slot", "valid"),
                                          (want[0], want[1], want[3]),
                                          (got[0], got[1], got[3])):
                        assert_same(np.asarray(w), g, f"{what}: {name}")
                    np.testing.assert_allclose(
                        got[2].numpy(), np.asarray(want[2]), atol=PLAN_TOL,
                        rtol=PLAN_TOL, err_msg=f"{what}: weight")


def test_the_steal_reroutes_overflow_that_the_baseline_drops():
    """The paper's point inside the model: on skewed routing the GShard
    baseline drops assignments, the bulk steal places every one."""
    probs = torch.from_numpy(_probs(np.random.default_rng(7), 128, 8,
                                    "skewed"))
    cap = moe.capacity_of(128, 2, 8, 1.0)
    e0, _, _, valid0 = moe.route_with_bulk_steal(probs, 2, cap, False)
    e1, s1, _, valid1 = moe.route_with_bulk_steal(probs, 2, cap, True)
    assert int((~valid0).sum()) > 0 and bool(valid1.all())
    assert int((e1 != e0).sum()) == int((~valid0).sum())
    keys = (e1.long() * cap + s1.long()).tolist()
    assert len(set(keys)) == len(keys)


def _moe_params(rng, D, E, F):
    return {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
            "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) * 0.1,
            "w_up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.1,
            "w_down": rng.standard_normal((E, F, D)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("chunk_tokens", [None, 16])
@pytest.mark.parametrize("steal", [True, False])
def test_moe_apply_matches_in_float32(monkeypatch, chunk_tokens, steal):
    """Whole batch in one chunk, and (``MOE_CHUNK_TOKENS`` 16 in both
    packages) 48 tokens in 3 chunks of 16, each its own push + steal."""
    if chunk_tokens:
        monkeypatch.setattr(jmoe, "MOE_CHUNK_TOKENS", chunk_tokens)
        monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", chunk_tokens)
    rng = np.random.default_rng(11)
    p = _moe_params(rng, 32, 8, 24)
    x = rng.standard_normal((3, 16, 32)).astype(np.float32)
    kw = dict(top_k=2, n_experts=8, capacity_factor=1.0, bulk_steal=steal)
    want = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), sh=ShardPlan(),
                          compute_dtype=jnp.float32, **kw)
    got = moe.moe_apply(params_from_numpy(p, CPU), torch.from_numpy(x),
                        compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_moe_apply_takes_ep_shardmap_without_a_mesh_and_refuses_others():
    rng = np.random.default_rng(12)
    p = params_from_numpy(_moe_params(rng, 16, 4, 8), CPU)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    kw = dict(top_k=2, n_experts=4, capacity_factor=1.25,
              compute_dtype=torch.float32)
    assert torch.equal(moe.moe_apply(p, x, impl="ep_shardmap", **kw),
                       moe.moe_apply(p, x, **kw))
    with pytest.raises(ValueError, match="impl"):
        moe.moe_apply(p, x, impl="dense", **kw)


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                               compute_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(tree_np(jp), CPU)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_moe_prefill_and_decode_match(arch):
    """Prefill (capacity factor 1.25) and three decode steps (2.0), the
    scalar-position path; mixtral's layers are windowed (ring caches)."""
    jm, tm, jp, tp = _models(arch)
    assert set(tp["blocks"]["g0"]) >= {"moe"} and "mlp" not in tp[
        "blocks"]["g0"]
    S = 20
    toks = np.random.default_rng(5).integers(
        1, tm.cfg.vocab_size, (2, S + 3)).astype(np.int32)
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S]))
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    jcache = jm.grow_cache(jcache, S + 8)
    tcache = tm.grow_cache(tcache, S + 8)
    for t in range(3):
        step = toks[:, S + t:S + t + 1]
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(step))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"decode step {t}")


def test_moe_decode_with_per_row_positions_matches_scalar_rows():
    """Continuous decode's per-row positions reach the MoE layers: a batch
    of two rows at different positions gives each row's scalar-position
    logits (MoE routes each decode batch as one chunk, so the rows run
    alone on the scalar path, batch 1 each)."""
    _, tm, _, tp = _models("qwen3-moe-30b-a3b")
    toks = np.random.default_rng(6).integers(1, 512, (2, 12)).astype(
        np.int32)
    caches, want = [], []
    for r, S in enumerate((7, 11)):
        _, c = tm.prefill(tp, torch.from_numpy(toks[r:r + 1, :S]))
        c = tm.grow_cache(c, 16)
        caches.append(c)
        want.append(tm.decode_step(tp, {**c, "g0": {
            kv: c["g0"][kv].clone() for kv in ("k", "v")}},
            torch.from_numpy(toks[r:r + 1, S:S + 1]))[0])
    batched = {"pos": torch.tensor([7, 11], dtype=torch.int32),
               "g0": {kv: torch.cat([c["g0"][kv] for c in caches], 1)
                      for kv in ("k", "v")}}
    step = torch.from_numpy(np.stack([toks[0, 7:8], toks[1, 11:12]]))
    got, _ = tm.decode_step(tp, batched, step)
    np.testing.assert_allclose(got.numpy(), torch.cat(want).numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
