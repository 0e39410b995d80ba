"""The port's enc-dec family (``models.encdec.EncDecLM``, seamless-m4t-medium
reduced) and cross-attention against the JAX package on the CPU.

Parameters are made by the JAX package and carried over with
``params_from_numpy``; inputs are drawn with numpy from fixed seeds.
Tolerances are the other parity files': logits and caches 1e-4 in float32
and 2e-2 in bfloat16 (``test_torch_models.py``), the loss 1e-5 and every
gradient leaf 1e-4 of its largest |g| (+ 1e-7), train steps as in
``test_torch_train.py`` (loss 1e-5, parameters 1e-5 after AdamW with
``eps`` 1e-6).
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models.attention import AttnConfig as JaxAttnConfig
from repro.models.attention import attention as jax_attention
from repro.models.attention import attn_init as jax_attn_init
from repro.models.layers import ShardPlan as JaxShardPlan
from repro.train import optimizer as jopt
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch._tree import tree_leaves_with_path
from repro_torch.models.attention import AttnConfig, attention
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import make_train_step, value_and_grad

from _torch_parity import one_torch_thread, tree_np  # noqa: F401

CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-7
PARAM_ATOL, STEP_EPS = 1e-5, 1e-6


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(compute_dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(ARCH)),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(configs.reduced(configs.get(ARCH)),
                               compute_dtype=compute_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(tree_np(jp), CPU)


def _inputs(cfg, B=2, S_enc=20, S=12, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_enc, cfg.frontend_dim)
                                 ).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return frames, toks


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("mode", ["cross", "bidirectional"])
@pytest.mark.parametrize("K", [4, 2])
def test_attention_cross_and_bidirectional_match(mode, K):
    """Cross-attention over a source of another length (no RoPE, no mask)
    and the encoder's bidirectional self-attention (RoPE, no mask), with
    the cached K / V of ``return_kv``, in float32."""
    D, H, hd = 64, 4, 16
    jcfg = JaxAttnConfig(n_heads=H, n_kv_heads=K, head_dim=hd,
                         causal=False)
    tcfg = AttnConfig(n_heads=H, n_kv_heads=K, head_dim=hd, causal=False)
    jp = jax_attn_init(jax.random.PRNGKey(3), 1, D, jcfg, jnp.float32)
    jp = jax.tree.map(lambda a: a[0], jp)
    tp = params_from_numpy(tree_np(jp), CPU)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    src = rng.standard_normal((2, 11, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mode == "cross":
        kw_j["kv_x"], kw_t["kv_x"] = jnp.asarray(src), torch.from_numpy(src)
    want, (wk, wv) = jax_attention(jp, jnp.asarray(x), jcfg, JaxShardPlan(),
                                   jnp.float32, return_kv=True, **kw_j)
    got, (gk, gv) = attention(tp, torch.from_numpy(x), tcfg, torch.float32,
                              return_kv=True, **kw_t)
    T = 11 if mode == "cross" else 7
    assert tuple(gk.shape) == (2, T, K, hd) == wk.shape
    for g, w, what in ((got, want, "out"), (gk, wk, "k"), (gv, wv, "v")):
        np.testing.assert_allclose(_np32(g), _np32(w), atol=1e-5, rtol=1e-5,
                                   err_msg=what)


# --------------------------------------------------------------- the model


def test_build_model_gives_an_encdec_with_the_jax_layout():
    jm, tm, jp, tp = _models()
    assert isinstance(tm, EncDecLM)
    fresh = tm.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), fresh)
    assert jax.tree.map(lambda a: str(a.dtype), jp) == jax.tree.map(
        lambda t: str(t.dtype).replace("torch.", ""), fresh)


def test_loss_and_every_gradient_leaf_match():
    jm, tm, jp, tp = _models()
    assert tm.cfg.remat
    frames, toks = _inputs(tm.cfg, seed=9)
    mask = (np.random.default_rng(10).random(toks[:, 1:].shape) < 0.8
            ).astype(np.float32)
    batch = {"frames": frames, "tokens": toks[:, :-1],
             "labels": toks[:, 1:], "loss_mask": mask}
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


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_grow_and_three_decode_steps_match(compute_dtype):
    jm, tm, jp, tp = _models(compute_dtype)
    frames, toks = _inputs(tm.cfg, S=12, seed=5)
    toks = np.concatenate([toks, toks[:, :2]], axis=1)   # 12 + 3 tokens
    S, tol = 12, TOL[compute_dtype]
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(frames),
                                     jnp.asarray(toks[:, :S]))
    tl, tcache = tm.prefill(tp, torch.from_numpy(frames),
                            torch.from_numpy(toks[:, :S]))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                               rtol=tol)
    assert tcache["pos"] == int(jcache["pos"]) == S
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            got, want = tcache[part][kv], jcache[part][kv]
            assert tuple(got.shape) == want.shape and got.dtype == tm.cdtype
            np.testing.assert_allclose(_np32(got), _np32(want), atol=tol,
                                       rtol=tol, err_msg=f"{part}.{kv}")

    jcache, tcache = jm.grow_cache(jcache, S + 8), tm.grow_cache(tcache,
                                                                  S + 8)
    assert tuple(tcache["self"]["k"].shape) == jcache["self"]["k"].shape
    assert tcache["cross"]["k"] is not None
    assert not tcache["self"]["k"][:, :, S:].any()
    for t in range(3):
        step = toks[:, S + t:S + t + 1]
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(step))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol, err_msg=f"decode step {t}")
    assert tcache["pos"] == S + 3
    np.testing.assert_allclose(_np32(tcache["self"]["k"]),
                               _np32(jcache["self"]["k"]), atol=tol,
                               rtol=tol)


def test_make_cache_matches_the_jax_layout():
    jm, tm, _, _ = _models("bfloat16")
    want = jm.make_cache(3, 40, 24)
    got = tm.make_cache(3, 40, 24, device=CPU)
    assert got["pos"] == int(want["pos"]) == 0
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            assert tuple(got[part][kv].shape) == want[part][kv].shape
            assert got[part][kv].dtype == torch.bfloat16
            assert not got[part][kv].any()


def test_three_train_steps_match():
    jm, tm, jp, tp = _models()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=STEP_EPS)
    jstep = jax.jit(jax_make_train_step(jm, jopt.AdamWConfig(**kw)))
    tstep = make_train_step(tm, topt.AdamWConfig(**kw))
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for i in range(3):
        frames, toks = _inputs(tm.cfg, B=2, S_enc=16, S=16, seed=20 + i)
        raw = {"frames": frames, "tokens": toks[:, :-1],
               "labels": toks[:, 1:]}
        jp, jstate, jmet = jstep(jp, jstate,
                                 {k: jnp.asarray(v) for k, v in raw.items()})
        tp, tstate, tmet = tstep(tp, tstate, {k: torch.from_numpy(v)
                                              for k, v in raw.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        want = dict(tree_leaves_with_path(tree_np(jp)))
        for key, g in tree_leaves_with_path(tp):
            np.testing.assert_allclose(_np32(g), want[key], atol=PARAM_ATOL,
                                       rtol=0, err_msg=f"step {i}: {key}")


# ------------------------------------------------------------ launch/train


def test_launch_train_batch_has_the_jax_frames():
    from repro_torch.launch.train import make_batch
    cfg = configs.reduced(configs.get(ARCH))
    raw = {"tokens": np.ones((2, 16), np.int32),
           "labels": np.ones((2, 16), np.int32)}
    batch = make_batch(cfg, raw, CPU)
    assert tuple(batch["frames"].shape) == (2, 16, cfg.frontend_dim)
    assert batch["frames"].dtype == torch.float32
    assert bool((batch["frames"] == 1).all())


def test_launch_train_encdec_stopped_and_resumed_equals_one_run(
        tmp_path, monkeypatch, capsys):
    """``--arch seamless-m4t-medium``: a SIGTERM after step 2 (of 4)
    checkpoints and exits; a second run resumes there and ends bit-equal
    to one uninterrupted run."""
    from repro_torch.launch import train as launch_train

    args = ["--device", "cpu", "--arch", ARCH, "--steps", "4", "--batch",
            "2", "--seq", "16", "--log-every", "1", "--ckpt-every", "100"]
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")]) == 4

    real = launch_train.make_train_step

    def stopping(model, opt_cfg, microbatch=0):
        step = real(model, opt_cfg, microbatch=microbatch)
        calls = {"n": 0}

        def wrapped(*a):
            out = step(*a)
            calls["n"] += 1
            if calls["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    monkeypatch.setattr(launch_train, "make_train_step", stopping)
    b = str(tmp_path / "b")
    assert launch_train.main(args + ["--ckpt-dir", b]) == 2
    monkeypatch.setattr(launch_train, "make_train_step", real)
    assert launch_train.main(args + ["--ckpt-dir", b]) == 4
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[train] step")]
    assert all(np.isfinite(losses))

    cfg, model = launch_train.build(ARCH, "smoke")
    assert isinstance(model, EncDecLM)
    p0 = model.init(torch.Generator().manual_seed(0))
    template = (p0, topt.adamw_init(p0))
    want, step_a, _ = ckpt.restore(str(tmp_path / "a"), template)
    got, step_b, _ = ckpt.restore(b, template)
    assert step_a == step_b == 4
    for (k, w), (_, g) in zip(tree_leaves_with_path(want),
                              tree_leaves_with_path(got)):
        assert torch.equal(w, g), k
