"""The port's configs and decoder model against the JAX package on the CPU.

Parameters are made by the JAX package and carried over with
``params_from_numpy``; inputs are drawn with numpy.  Float32 compute must
agree to ``atol = rtol = 1e-4`` on logits; bfloat16 compute, where the two
frameworks round at different places, to ``2e-2`` (``tests/test_serve.py``'s
tolerance).  The JAX package's attention computes its logits and softmax
weights in the compute dtype before the products; the port's K6 (its
plain version here) keeps them in float32, which the bfloat16 tolerance
covers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models.attention import rope as jax_rope
from repro.models.layers import ShardPlan
from repro.models.layers import mlp_apply as jax_mlp_apply
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch import configs
from repro_torch.models.attention import rope
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.zoo import build_model, params_from_numpy

from _torch_parity import assert_same, one_torch_thread, tree_np  # noqa: F401

CPU = torch.device("cpu")


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return params_from_numpy(np.asarray(a), CPU)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_jax_package(arch):
    for mine, theirs in ((configs.get(arch), jconfigs.get(arch)),
                         (configs.reduced(configs.get(arch)),
                          jconfigs.reduced(jconfigs.get(arch)))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        for prop in ("hd", "padded_vocab", "d_inner", "n_ssm_heads",
                     "is_subquadratic", "has_decode"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop
        assert mine.param_count() == theirs.param_count()
        assert ([s.name for s in configs.cells_for(mine)]
                == [s.name for s in jconfigs.cells_for(theirs)])
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


# ------------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jax_rms_norm(jx, jnp.asarray(w), 1e-6)
    got = rms_norm(_t(np.asarray(jx)), _t(w), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("fraction,theta,batched", [
    (1.0, 500_000.0, False), (0.5, 10_000.0, True), (1.0, 10_000.0, True)])
def test_rope_matches(fraction, theta, batched):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = (rng.integers(0, 1000, (2, 7)) if batched
           else np.arange(7) + 1033).astype(np.int32)
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    got = rope(_t(x), _t(pos), theta, fraction)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches(dtype):
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = jax_mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), ShardPlan(), jnp.dtype(dtype))
    got = mlp_apply(params_from_numpy(p, CPU), _t(x), getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


def test_initializers_follow_the_jax_layout():
    gen = torch.Generator().manual_seed(0)
    p = mlp_init(gen, 3, 16, 40, torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_gate": (3, 16, 40), "w_up": (3, 16, 40), "w_down": (3, 40, 16)}
    assert 0.015 < float(p["w_gate"].std()) < 0.025
    cfg = configs.reduced(configs.get("gemma2-9b"))
    tparams = build_model(cfg).init(torch.Generator().manual_seed(0))
    jparams = jax_build_model(jconfigs.reduced(jconfigs.get("gemma2-9b"))
                              ).init(jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), tparams)


# --------------------------------------------------------------- DecoderLM


def _models(arch, compute_dtype):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                               compute_dtype=compute_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(tree_np(jp), CPU)


def _cache_to_torch(cache):
    out = params_from_numpy(tree_np({k: v for k, v in cache.items()
                                     if k != "pos"}), CPU)
    out["pos"] = int(cache["pos"])
    return out


# S = 12 prefills gemma2's local layers (window 16) into a ring of 12 and
# grows it to 16 (re-layout); S = 20 fills a ring of 16 that decode wraps.
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-9b"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [12, 20])
def test_prefill_grow_and_decode_match(arch, compute_dtype, S):
    jm, tm, jp, tp = _models(arch, compute_dtype)
    toks = np.random.default_rng(S).integers(
        1, tm.cfg.vocab_size, (2, S + 3)).astype(np.int32)
    tol = 1e-4 if compute_dtype == "float32" else 2e-2

    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S]))
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    assert tcache["pos"] == int(jcache["pos"]) == S
    for name in jcache:
        if name != "pos":
            for kv in ("k", "v"):
                assert tcache[name][kv].shape == jcache[name][kv].shape
                assert tcache[name][kv].dtype == tm.cdtype

    # grow_cache: the same input cache gives the same bits.
    target = S + 8
    jgrown = jm.grow_cache(jcache, target)
    mine = tm.grow_cache(_cache_to_torch(jcache), target)
    for name in jgrown:
        if name != "pos":
            for kv in ("k", "v"):
                assert_same(np.asarray(jgrown[name][kv]), mine[name][kv],
                            f"grow_cache {name}.{kv}")
    assert mine["pos"] == S

    jcache, tcache = jgrown, tm.grow_cache(tcache, target)
    for t in range(3):
        step = toks[:, S + t:S + t + 1]
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(step))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol, err_msg=f"decode step {t}")
    assert tcache["pos"] == S + 3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-9b"])
def test_make_cache_matches_the_jax_layout(arch):
    jm, tm, _, _ = _models(arch, "bfloat16")
    want = jm.make_cache(3, 40)
    got = tm.make_cache(3, 40, device=CPU)
    assert got["pos"] == int(want["pos"]) == 0
    for name in want:
        if name != "pos":
            for kv in ("k", "v"):
                assert tuple(got[name][kv].shape) == want[name][kv].shape
                assert got[name][kv].dtype == torch.bfloat16
                assert not got[name][kv].any()


def test_forward_matches():
    jm, tm, jp, tp = _models("gemma2-9b", "float32")
    toks = np.random.default_rng(3).integers(1, 512, (2, 24)).astype(np.int32)
    want = jm.forward(jp, jnp.asarray(toks))
    got = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch,error", [
    ("qwen3-moe-30b-a3b", "item 10"), ("internvl2-2b", "item 10"),
    ("seamless-m4t-medium", "item 10")])
def test_families_not_ported_yet_raise(arch, error):
    """The three families that once raised naming their queue item are
    all ported: the MoE and VLM ones build a ``DecoderLM`` and the enc-dec
    one an ``EncDecLM``."""
    from repro_torch.models.encdec import EncDecLM
    cfg = configs.reduced(configs.get(arch))
    model = build_model(cfg)
    want = EncDecLM if cfg.family == "encdec" else DecoderLM
    assert isinstance(model, want), (arch, error)


# ---------------------------------------------------------- the VLM prefix


def _vlm_inputs(tm, B=2, S=12, seed=8):
    rng = np.random.default_rng(seed)
    cfg = tm.cfg
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim)
                                  ).astype(np.float32)
    return toks, patches


def test_vlm_prefix_forward_prefill_and_loss_match():
    """internvl2's patch prefix: the hidden states over patches + text, the
    prefill's last logits and cache length, and the loss over the text
    positions only, in float32 (``atol = rtol = 1e-4``)."""
    jm, tm, jp, tp = _models("internvl2-2b", "float32")
    toks, patches = _vlm_inputs(tm)
    P = tm.cfg.n_patches
    assert tuple(tp["patch_proj"].shape) == (tm.cfg.frontend_dim,
                                             tm.cfg.d_model)
    want = jm.forward(jp, jnp.asarray(toks[:, :-1]), jnp.asarray(patches))
    got = tm.forward(tp, torch.from_numpy(toks[:, :-1]),
                     torch.from_numpy(patches))
    assert got.shape[1] == P + toks.shape[1] - 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)

    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :-1]),
                                     jnp.asarray(patches))
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :-1]),
                            torch.from_numpy(patches))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert tcache["pos"] == int(jcache["pos"]) == P + toks.shape[1] - 1

    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": patches}
    want = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- loss and gradients


GRAD_ARCHS = ["llama3.2-1b", "gemma2-9b", "qwen3-moe-30b-a3b",
              "mixtral-8x22b", "internvl2-2b", "mamba2-2.7b", "zamba2-7b"]
# float32 compute: the loss to 1e-5; each gradient leaf to 1e-4 of its
# largest |g| (+ 1e-7), the two frameworks summing in different orders
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-7


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax_value_and_grad(arch):
    from repro_torch._tree import tree_leaves_with_path
    from repro_torch.train.trainer import value_and_grad

    jm, tm, jp, tp = _models(arch, "float32")
    assert tm.cfg.remat
    rng = np.random.default_rng(9)
    toks = rng.integers(1, tm.cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": (rng.random((2, 32)) < 0.8).astype(np.float32)}
    if tm.cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, tm.cfg.n_patches, tm.cfg.frontend_dim)).astype(np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = value_and_grad(
        tm.loss_fn, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    want = dict(tree_leaves_with_path(tree_np(jgrads)))
    got = dict(tree_leaves_with_path(tgrads))
    assert set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        assert tuple(g.shape) == w.shape, key
        scale = float(np.abs(w).max())
        assert scale > 0, f"{key}: no gradient"
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=key)


def test_params_from_numpy_keeps_bits_and_dtypes():
    tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) / 7,
            "b": {"c": jnp.linspace(-3, 3, 5).astype(jnp.bfloat16),
                  "d": jnp.arange(4, dtype=jnp.int32)}}
    got = params_from_numpy(tree_np(tree), CPU)
    assert got["b"]["c"].dtype == torch.bfloat16
    assert got["b"]["d"].dtype == torch.int32
    for want, mine in ((tree["a"], got["a"]), (tree["b"]["c"], got["b"]["c"]),
                       (tree["b"]["d"], got["b"]["d"])):
        assert_same(np.asarray(want), mine)
