"""The port's sharded-model path against the JAX package on the CPU.

* Spec trees: ``param_specs``, ``cache_specs`` and ``opt_state_specs`` of
  every arch equal the JAX package's leaf for leaf (the port's ``P``
  against ``jax.sharding.PartitionSpec``, entry for entry).
* One module-scoped spawn of 8 ``gloo`` CPU ranks as a ``(data 2, model
  4)`` model mesh (``tests/_torch_sharded.py``, with a time limit of its
  own) runs the two explicit-collective bodies and the mesh's tree
  functions.  The JAX package's own tests of those bodies
  (``tests/test_perf_variants.py``) assert that they equal its unsharded
  functions; here every rank's results are held against exactly those
  unsharded functions on the same inputs: flash-decoding against
  ``decode_step`` without a mesh (float32, ``atol = rtol = 1e-4``), and
  expert-parallel MoE against ``moe_apply(impl="gspmd")`` (the JAX test's
  ``atol 2e-5``, ``rtol 2e-4``).  Where the JAX package's bodies return
  None (a window, ``C % tp``, ``E % tp``) the port's land on the
  unsharded path.
* The sharded step (``with mesh.spmd():``, every tensor this rank's block
  by its spec) in the same spawn: one AdamW step of each reduced arch
  (llama3.2-1b, qwen3-moe-30b-a3b with 8 experts and with 16 over the
  model axis, mamba2-2.7b, zamba2-7b, seamless-m4t-medium) against the
  JAX package's unsharded ``value_and_grad(loss_fn)`` and the AdamW
  update its ``make_train_step`` applies to that gradient (loss within
  1e-5, each gathered gradient leaf within 1e-4 of its largest |g|,
  parameters within 1e-5), the MoE's
  routing plans equal to the unsharded dispatch's; the sharded prefill
  (logits within 1e-4, each cache block the JAX package's cache cut by
  ``cache_specs``); a llama decode step on a sequence-split cache; a llama
  step on a ``(pod 2, data 2, model 2)`` mesh; and each rank's FLOPs and
  rank 0's collective log of its real step equal to the dry run's
  ``trace_cell`` of the same step on ``meta``.
"""

import dataclasses
import functools
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_sharded as M
from repro import configs as jconfigs
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.layers import ShardPlan as JaxShardPlan
from repro.train import optimizer as jopt
from repro.train.optimizer import opt_state_specs as jax_opt_state_specs
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import run_workers
from repro_torch.models import transformer as tmod
from repro_torch.models.layers import P
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import opt_state_specs

from _torch_parity import tree_np, one_torch_thread  # noqa: F401

PLANS = {"default": None, "parallel": {}, "pods": {"pod_axis": "pod"}}


def _plain(tree):
    """A spec tree of either package as nested dicts / lists of tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (P, jax.sharding.PartitionSpec)):
        return ("P",) + tuple(tree)
    if isinstance(tree, (list, tuple)):
        return [_plain(x) for x in tree]
    return tree


def _pair(arch, plan):
    kw = PLANS[plan]
    jpar = None if kw is None else JaxParallelConfig(**kw)
    tpar = None if kw is None else ParallelConfig(**kw)
    return (jax_build_model(jconfigs.get(arch), jpar),
            build_model(configs.get(arch), tpar))


# ------------------------------------------------------------- spec trees


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_jax_package(arch, plan):
    jm, tm = _pair(arch, plan)
    want = _plain(jm.param_specs())
    assert _plain(tm.param_specs()) == want
    # and the tree is init's: one spec per parameter, as long as its rank
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    ranks = jax.tree.map(lambda s: len(s.shape), shapes)
    spec_ranks = jax.tree.map(len, jm.param_specs(),
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))
    assert ranks == spec_ranks


@pytest.mark.parametrize("batch", [0, 8, 32])
@pytest.mark.parametrize("seq_len", [1024, 8192])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_the_jax_package(arch, seq_len, batch):
    jm, tm = _pair(arch, "pods")
    assert (_plain(tm.cache_specs(seq_len, batch))
            == _plain(jm.cache_specs(seq_len, batch)))


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-7b"])
def test_opt_state_specs_equal_the_jax_package(arch, master):
    jm, tm = _pair(arch, "parallel")
    want = jax_opt_state_specs(jm.param_specs(), master_weights=master)
    got = opt_state_specs(tm.param_specs(), master_weights=master)
    assert _plain(got) == _plain(want)
    assert (got.master == ()) == (not master)


def test_spec_entries_are_normalised_like_jax():
    for entries in [(None, ("data",), "model"), ((), None),
                    (("pod", "data"), None), ()]:
        assert tuple(P(*entries)) == tuple(
            jax.sharding.PartitionSpec(*entries))
    assert P("a", None) == P(("a",), None) and P("a") != P("a", None)


# ------------------------------------------------- the 8-rank model mesh


def _jax_model(arch, **changes):
    cfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                              compute_dtype="float32", **changes)
    model = jax_build_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _moe_params(E, seed):
    rng = np.random.default_rng(seed)
    D, F = M.MOE["D"], M.MOE["F"]
    return ({"router": rng.standard_normal((D, E)).astype(np.float32) * 0.1,
             "w_gate": rng.standard_normal((E, D, F)).astype(np.float32)
             * 0.05,
             "w_up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.05,
             "w_down": rng.standard_normal((E, F, D)).astype(np.float32)
             * 0.05},
            rng.standard_normal((4, 16, D)).astype(np.float32))


def _decode_reference(arch, data, grow):
    """The JAX package's unsharded prefill, grow and two decode steps over
    all 16 rows."""
    jm, jp = _jax_model(arch)
    data[f"{arch}/params"] = tree_np(jp)
    toks = np.random.default_rng(1).integers(
        1, jm.cfg.vocab_size, (M.FLASH["batch"], M.FLASH["prompt"] + 2)
    ).astype(np.int32)
    data[f"{arch}/tokens"] = toks
    S = M.FLASH["prompt"]
    _, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S]))
    cache = jm.grow_cache(cache, grow)
    out = []
    for t in range(2):
        lg, cache = jax.jit(jm.decode_step)(jp, cache,
                                            jnp.asarray(toks[:, S + t:S + t
                                                             + 1]))
        out.append(np.asarray(lg))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    data, want = {}, {}
    want["llama"] = _decode_reference("llama3.2-1b", data, M.FLASH["grow"])
    want["gemma2"] = _decode_reference("gemma2-9b", data, M.FLASH["grow"])
    for E in (8, 6):
        p, x = _moe_params(E, seed=E)
        data[f"moe{E}/params"], data[f"moe{E}/x"] = p, x
        want[f"moe{E}"] = np.asarray(jax_moe.moe_apply(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            top_k=M.MOE["k"], n_experts=E,
            capacity_factor=M.MOE["capacity_factor"], sh=JaxShardPlan(),
            compute_dtype=jnp.float32, impl="gspmd"))
    jm, jp = _jax_model("qwen3-moe-30b-a3b")
    data["qwen3-moe-30b-a3b/params"] = tree_np(jp)
    toks = np.random.default_rng(2).integers(
        1, jm.cfg.vocab_size, (4, 12)).astype(np.int32)
    data["qwen3-moe-30b-a3b/tokens"] = toks
    want["qwen3"] = [np.asarray(jax.jit(jm.prefill)(
        jp, jnp.asarray(toks[2 * d:2 * d + 2]))[0]) for d in range(2)]
    models = {}
    for name in M.STEP_ARCHS:
        arch, changes = M.step_arch(name)
        jm, jp = models[name] = _jax_model(arch, **changes)
        data[f"step/{name}/params"] = tree_np(jp)
        data[f"step/{name}/batch"] = M.step_batch(jm.cfg)
    path = tmp_path_factory.mktemp("sharded") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    # the ranks run while this process computes the sharded-step cases'
    # JAX references, which they do not need
    ranks = {}
    spawn = threading.Thread(target=lambda: ranks.update(out=_run(
        M.program(str(path)))))
    spawn.start()
    try:
        for name in M.STEP_ARCHS:
            want[f"step/{name}"] = _step_reference(
                name, *models[name], data[f"step/{name}/batch"])
    finally:
        spawn.join()
    if isinstance(ranks["out"], BaseException):
        raise ranks["out"]
    return ranks["out"], want


def _run(fn):
    try:
        return run_workers(fn, M.N_RANKS, timeout=240)
    except BaseException as e:   # raised again in the fixture's thread
        return e


def _step_reference(name, jm, jp, batch):
    """The JAX package's unsharded loss, gradient, train step and prefill
    of a sharded-step case on ``batch``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, jb)
    # the JAX package's train step is this gradient through adamw_update
    # (repro.train.trainer.make_train_step without microbatches)
    update = jax.jit(functools.partial(jopt.adamw_update,
                                       jopt.AdamWConfig(**M.STEP_OPT)))
    new, _, _ = update(grads, jopt.adamw_init(jp), jp)
    out = {"loss": float(loss), "grads": tree_np(grads),
           "params": tree_np(new)}
    if name in M.PREFILL_ARCHS:
        if jm.cfg.family == "encdec":
            logits, cache = jax.jit(jm.prefill)(jp, jb["frames"],
                                                jb["tokens"])
        else:
            logits, cache = jax.jit(jm.prefill)(jp, jb["tokens"])
        out["logits"], out["cache"] = np.asarray(logits), tree_np(cache)
    return out


def _rows(rank_out, n):
    d = rank_out["coords"]["data"]
    return slice(d * n, (d + 1) * n)


def test_ranks_form_the_data_model_grid(mesh_run):
    ranks, _ = mesh_run
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in range(2) for m in range(4)]


def test_shard_and_gather_round_trip_a_tree(mesh_run):
    ranks, _ = mesh_run
    for r in ranks:
        rt = r["round_trip"]
        assert rt["params_equal"] and rt["cache_equal"]
        # embed P(model, data): 512 x 128 in blocks of 128 x 64; the batch-8
        # cache's 40 positions over data x model: 5 a rank
        assert rt["embed_local"] == [128, 64]
        assert rt["cache_local"][2] == 5


@pytest.mark.parametrize("arch", ["llama", "gemma2"])
def test_flash_decoding_matches_the_unsharded_decode(mesh_run, arch):
    """Every rank's logits of its data rank's 8 rows, two decode steps on
    the sequence-sharded cache (10 positions a model rank), within 1e-4
    of the JAX package's unsharded ``decode_step``.  gemma2's windowed
    layers (ring caches of 16) stay unsharded and take the plain decode,
    where the JAX package's body returns None."""
    ranks, want = mesh_run
    for r in ranks:
        got = r[arch]
        want_len = ({"g0": 40} if arch == "llama"
                    else {"g0": None, "g1": 40})  # gemma2's ring, whole
        assert got["seq_len"] == want_len and got["pos"] == 34
        n_global = 4 if arch == "llama" else 2     # layers per decode step
        assert got["flash_calls"] == 2 * n_global
        shapes = got["cache_shapes"]
        assert shapes["g0" if arch == "llama" else "g1"][2] == 10
        if arch == "gemma2":
            assert shapes["g0"][2] == 16            # the ring, whole
        for t in range(2):
            np.testing.assert_allclose(
                got["logits"][t], want[arch][t][_rows(r, 8)], atol=1e-4,
                rtol=1e-4, err_msg=f"rank {r['coords']} step {t}")


def test_flash_decoding_writes_only_the_owners_slice(mesh_run):
    """Model rank m holds positions 10 m .. 10 m + 9.  Ranks 0-2 hold
    prefill rows only; rank 3 holds 30 and 31 from the prefill, 32 and 33
    from the two decode steps (it owns them), and 34-39 still zero."""
    ranks, _ = mesh_run
    for r in ranks:
        k = r["llama"]["g0_k"]          # (L, 8, 10, K, hd)
        filled = np.abs(k).max(axis=(0, 1, 3, 4)) > 0
        want = np.arange(10) + 10 * r["coords"]["model"] < 34
        np.testing.assert_array_equal(filled, want)


def test_a_cache_the_model_axis_does_not_divide_decodes_unsharded(mesh_run):
    ranks, want = mesh_run
    for r in ranks:
        got = r["llama_c_mod_tp"]
        assert got["seq_len"] == {"g0": None} and got["flash_calls"] == 0
        assert got["cache_shapes"]["g0"][2] == 42
        for t in range(2):
            np.testing.assert_allclose(got["logits"][t],
                                       want["llama"][t][_rows(r, 8)],
                                       atol=1e-4, rtol=1e-4)


def test_flash_body_returns_none_where_the_jax_body_does(mesh_run):
    ranks, _ = mesh_run
    for r in ranks:
        ref = r["refusals"]
        assert ref["no_mesh"] and ref["window"] and ref["c_mod_tp"]
        assert ref["taken"]


@pytest.mark.parametrize("E", [8, 6])
def test_expert_parallel_moe_matches_gspmd(mesh_run, E):
    """E 8: each model rank holds 2 experts and the EP body runs; E 6 does
    not divide the 4 model ranks, so the body returns None and the
    dispatch runs whole, as in the JAX package.  Both within the JAX
    test's bound of ``moe_apply(impl="gspmd")``."""
    ranks, want = mesh_run
    for r in ranks:
        got = r[f"moe{E}"]
        assert got["ep_calls"] == (1 if E == 8 else 0)
        assert got["experts_held"] == (2 if E == 8 else 6)
        np.testing.assert_allclose(got["out"], want[f"moe{E}"][_rows(r, 2)],
                                   atol=2e-5, rtol=2e-4)


def test_expert_parallel_prefill_of_the_moe_model(mesh_run):
    """Reduced qwen3-moe (8 experts, 2 a model rank after
    ``shard_params``): each data rank's prefill, every MoE layer through
    the EP body, within 1e-4 of the JAX package's prefill of those rows."""
    ranks, want = mesh_run
    for r in ranks:
        got = r["qwen3"]
        assert got["experts_held"] == 2
        assert got["ep_calls"] == 4               # one per layer
        np.testing.assert_allclose(got["logits"],
                                   want["qwen3"][r["coords"]["data"]],
                                   atol=1e-4, rtol=1e-4)


def test_production_mesh_refuses_a_world_of_8(mesh_run):
    ranks, _ = mesh_run
    for r in ranks:
        assert "needs 256 ranks; the world has 8" in \
            r["refusals"]["production_mesh"]


# --------------------------------------------------- the sharded step


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _assert_grads(got, want, what):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-4 * scale, f"{what} {k}: {err} of {scale}"


@pytest.mark.parametrize("name", M.STEP_ARCHS)
def test_sharded_train_step_matches_the_unsharded_jax_step(mesh_run, name):
    """Every rank's loss within 1e-5 of the JAX package's unsharded loss,
    the gathered gradient within 1e-4 of each leaf's largest |g|, and the
    gathered parameters after the AdamW step within 1e-5."""
    ranks, want = mesh_run
    w = want[f"step/{name}"]
    for r in ranks:
        np.testing.assert_allclose(r["step"][name]["loss"], w["loss"],
                                   rtol=1e-5, atol=1e-5)
    got = ranks[0]["step"][name]
    _assert_grads(got["grads"], w["grads"], name)
    gp, wp = _flat(got["params"]), _flat(w["params"])
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], atol=1e-5, rtol=0,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen3-moe-ep"])
def test_sharded_moe_plans_equal_the_unsharded_plan(mesh_run, name):
    """Each rank routes every global chunk that holds its tokens by the
    plan of the unsharded dispatch, integer for integer (one per MoE
    layer)."""
    ranks, _ = mesh_run
    for r in ranks:
        assert r["step"][name]["plans"] == 4
        assert r["step"][name]["plans_equal"]


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_specs(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _cut(x, spec, coords, shape):
    """``mesh.shard``'s block of a numpy array."""
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n, i = 1, 0
        for a in names:
            i, n = i * shape[a] + coords[a], n * shape[a]
        if n > 1:
            w = x.shape[d] // n
            x = np.take(x, range(i * w, (i + 1) * w), axis=d)
    return x


@pytest.mark.parametrize("name", M.PREFILL_ARCHS)
def test_sharded_prefill_matches_the_unsharded_jax_prefill(mesh_run, name):
    """Each rank's logits of its data rank's 8 rows within 1e-4, and each
    cache block the JAX package's cache of all 16 rows cut by the port's
    ``cache_specs`` (the global layers' 32 positions split over the model
    axis, ``_SEQ_SHARD_MIN`` lowered to 16), within 1e-4."""
    ranks, want = mesh_run
    w = want[f"step/{name}"]
    arch, changes = M.step_arch(name)
    model = build_model(dataclasses.replace(
        configs.reduced(configs.get(arch)), **changes), ParallelConfig())
    shape = dict(zip(*reversed(M.MESH)))
    saved = tmod._SEQ_SHARD_MIN
    tmod._SEQ_SHARD_MIN = M.FLASH["seq_shard_min"]
    try:
        specs = model.cache_specs(M.STEP["seq"], M.STEP["batch"])
    finally:
        tmod._SEQ_SHARD_MIN = saved
    for r in ranks:
        got = r["prefill"][name]
        np.testing.assert_allclose(got["logits"], w["logits"][_rows(r, 8)],
                                   atol=1e-4, rtol=1e-4)
        gc, wc = _flat(got["cache"]), _flat(w["cache"])
        sc = _flat_specs(specs)
        assert gc.keys() == wc.keys()
        assert int(gc.pop("pos")) == int(wc.pop("pos")) == M.STEP["seq"]
        for k in gc:
            np.testing.assert_allclose(
                gc[k], _cut(wc[k], sc[k], r["coords"], shape),
                atol=1e-4, rtol=1e-4, err_msg=f"{name} {k} {r['coords']}")


def test_sharded_decode_matches_the_unsharded_jax_decode(mesh_run):
    """A llama decode step on the sequence-split cache (10 of 40 positions
    a model rank, merged across the model axis), every rank's logits
    within 1e-4 of the JAX package's unsharded ``decode_step``."""
    ranks, want = mesh_run
    for r in ranks:
        got = r["decode"]
        assert got["seq_len"] == 40 and got["cache_positions"] == 10
        np.testing.assert_allclose(got["logits"],
                                   want["llama"][0][_rows(r, 8)],
                                   atol=1e-4, rtol=1e-4)


def test_sharded_step_with_the_pod_axis(mesh_run):
    """One llama step on (pod 2, data 2, model 2): the batch over pod and
    data, the parameters replicated over the pods (their gradients summed
    over them), against the same JAX step."""
    ranks, want = mesh_run
    assert [r["pod_coords"] for r in ranks] == [
        {"pod": p, "data": d, "model": m}
        for p in range(2) for d in range(2) for m in range(2)]
    w = want["step/llama3.2-1b"]
    for r in ranks:
        np.testing.assert_allclose(r["pod_step"]["loss"], w["loss"],
                                   rtol=1e-5, atol=1e-5)
    got = ranks[0]["pod_step"]
    _assert_grads(got["grads"], w["grads"], "pods")
    gp, wp = _flat(got["params"]), _flat(w["params"])
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], atol=1e-5, rtol=0,
                                   err_msg=f"pods {k}")


@pytest.mark.parametrize("case", [("step", "llama3.2-1b"),
                                  ("step", "mamba2-2.7b"),
                                  ("pod_step", None)])
def test_the_dry_run_traces_what_the_real_step_does(mesh_run, case):
    """``trace_cell`` of the step on a recording mesh at rank 0's
    coordinates (``meta`` tensors) counts every rank's real FLOPs, and its
    collective log is rank 0's real one, call for call; K6 / K7 charge
    their own counts in both."""
    ranks, _ = mesh_run
    part, name = case
    rows = [r[part][name] if name else r[part] for r in ranks]
    trace = rows[0]["trace"]
    assert trace["log"] == rows[0]["log"]
    assert len(trace["log"]) > 0
    for r in rows:
        assert r["flops"] == trace["flops"] > 0
        assert r["kernels"]
