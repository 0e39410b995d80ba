"""The port's training path against the JAX package's on the CPU: the
chunked LM-head loss, the cosine schedule, AdamW, three train steps (and
microbatch accumulation), a checkpoint written by the JAX trainer resumed
by the port, and ``launch/train`` stopped and resumed against one
uninterrupted run.  Also the gradient wiring of K6 and K7's CUDA launches
(their ``autograd.Function``), with the launch replaced by the plain
version so that it runs here.

Tolerances (float32 compute): the loss 1e-5; ``grad_norm`` and ``lr``
1e-5 relative; parameters after AdamW steps 1e-5 absolute (an update moves
a weight by about ``lr`` = 1e-3, so this holds the update to 1 %); bf16
parameters to one bf16 step (2**-7 relative).  The model's train steps use
AdamW's ``eps`` = 1e-6: Adam's first update is ``g / (|g| + eps)``, so at
the default 1e-8 a gradient element of ~1e-9, which the two frameworks
round apart by a larger relative amount, moves its weight by a different
fraction of ``lr``; at 1e-6 those elements move by almost nothing in
either package.  ``test_adamw_update_matches_with_a_bf16_leaf`` holds the
update rule itself at the default ``eps``.
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
from repro.models.layers import ShardPlan
from repro.models.layers import chunked_ce_loss as jax_chunked_ce_loss
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch._tree import tree_leaves_with_path
from repro_torch.data.synthetic import synth_batch
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import make_train_step

from _torch_parity import one_torch_thread, tree_np  # noqa: F401

CPU = torch.device("cpu")
LOSS_TOL, METRIC_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
STEP_EPS = 1e-6


def _leaves(tree):
    """``{path: float32 numpy}`` of a JAX or torch tree."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], jax.Array):
        tree = tree_np(tree)
    return {k: np.asarray(torch.as_tensor(v).float().numpy()
                          if isinstance(v, torch.Tensor) else
                          np.asarray(v, np.float32))
            for k, v in tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, atol, what):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def llama():
    """Reduced llama3.2-1b in float32 compute, the JAX package's
    parameters in both packages."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("llama3.2-1b")),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                               compute_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp


def _batch(cfg, step, B=4, S=32):
    raw = synth_batch(0, 0, step, B, S, cfg.vocab_size)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


# --------------------------------------------------------------- the loss


@pytest.mark.parametrize("S,chunk,softcap,masked", [
    (32, 8, None, False), (30, 8, 30.0, True), (12, 512, None, True)])
def test_chunked_ce_loss_matches(S, chunk, softcap, masked):
    """Chunks that divide S, a ragged S (30 -> 3 chunks of 10), one chunk;
    the final softcap and a loss mask."""
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, S)).astype(np.int32)
    mask = (rng.random((2, S)) < 0.7).astype(np.float32) if masked else None
    want = jax_chunked_ce_loss(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), ShardPlan(),
        final_softcap=softcap, chunk=chunk)
    for remat in (True, False):
        ht = torch.from_numpy(h).requires_grad_(True)
        got = chunked_ce_loss(ht, torch.from_numpy(head),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask),
                              final_softcap=softcap, chunk=chunk,
                              remat=remat)
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        got.backward()
        assert torch.isfinite(ht.grad).all() and ht.grad.abs().sum() > 0


# ------------------------------------------------------------ the optimizer


def test_cosine_lr_matches():
    cfg = topt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 60):
        want = jopt.cosine_lr(jcfg, jnp.int32(step))
        got = topt.cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_with_a_bf16_leaf(master):
    """Three updates of a tree with a float32 matrix, a bfloat16 matrix
    and a float32 norm vector (not decayed); with ``master_weights`` the
    bf16 leaf is a cast of the float32 master, which must agree too."""
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b16": rng.standard_normal((4, 3)).astype(np.float32),
         "norm": np.ones(5, np.float32)}
    jp = {"w": jnp.asarray(p["w"]), "b16": jnp.asarray(p["b16"]).astype(
        jnp.bfloat16), "norm": jnp.asarray(p["norm"])}
    tp = params_from_numpy(tree_np(jp), CPU)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, master_weights=master)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstate = jopt.adamw_init(jp, master_weights=master)
    tstate = topt.adamw_init(tp, master_weights=master)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * (i + 1)
             for k, v in p.items()}
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = params_from_numpy(tree_np(jg), CPU)
        jp, jstate, jm = jopt.adamw_update(jcfg, jg, jstate, jp)
        tp, tstate, tm = topt.adamw_update(tcfg, tg, tstate, tp)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=METRIC_RTOL)
        assert tp["b16"].dtype == torch.bfloat16
        np.testing.assert_allclose(tp["b16"].float().numpy(),
                                   np.asarray(jp["b16"], np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)
        for k in ("w", "norm"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=PARAM_ATOL, rtol=0)
        for part in ("m", "v") + (("master",) if master else ()):
            _assert_trees_close(getattr(tstate, part), getattr(jstate, part),
                                PARAM_ATOL, f"step {i} {part}")
    assert int(tstate.step) == int(jstate.step) == 3
    assert (tstate.master == ()) == (not master)


# ----------------------------------------------------------- train steps


@pytest.mark.parametrize("microbatch", [0, 2])
def test_three_train_steps_match(llama, microbatch):
    jm, tm, jp = llama
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=STEP_EPS)
    jstep = jax.jit(jax_make_train_step(jm, jopt.AdamWConfig(**kw),
                                        microbatch=microbatch))
    tstep = make_train_step(tm, topt.AdamWConfig(**kw),
                            microbatch=microbatch)
    tp = params_from_numpy(tree_np(jp), CPU)
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for i in range(3):
        jb, tb = _batch(tm.cfg, i)
        jp, jstate, jmet = jstep(jp, jstate, jb)
        tp, tstate, tmet = tstep(tp, tstate, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[name]),
                                       float(jmet[name]), rtol=METRIC_RTOL)
        _assert_trees_close(tp, jp, PARAM_ATOL, f"params after step {i}")
    assert not any(t.requires_grad for t in _tensors(tp))


def _tensors(tree):
    return [v for _, v in tree_leaves_with_path(tree)]


def test_the_port_resumes_a_checkpoint_of_the_jax_trainer(llama, tmp_path):
    """The JAX trainer's checkpoint of (params, opt) after two steps
    restores into the port's tree (every key, shape and dtype), and the
    port's next step equals the JAX trainer's next step."""
    jm, tm, jp = llama
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=STEP_EPS)
    jstep = jax.jit(jax_make_train_step(jm, jopt.AdamWConfig(**kw)))
    jstate = jopt.adamw_init(jp)
    for i in range(2):
        jp, jstate, _ = jstep(jp, jstate, _batch(tm.cfg, i)[0])
    d = str(tmp_path / "ck")
    jckpt.save(d, 2, (jp, jstate), extra={"data": {"step": 2}})

    template = tm.init(torch.Generator().manual_seed(1))
    (tp, tstate), step, extra = ckpt.restore(
        d, (template, topt.adamw_init(template)), device=CPU)
    assert step == 2 and extra["data"]["step"] == 2
    assert int(tstate.step) == 2 and tstate.master == ()
    _assert_trees_close(tp, jp, 0.0, "restored params")

    jb, tb = _batch(tm.cfg, 2)
    jp, jstate, jmet = jstep(jp, jstate, jb)
    tp, tstate, tmet = make_train_step(tm, topt.AdamWConfig(**kw))(
        tp, tstate, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    _assert_trees_close(tp, jp, PARAM_ATOL, "params after the resumed step")
    _assert_trees_close(tstate.m, jstate.m, PARAM_ATOL, "first moment")


# --------------------------------------------------------- launch/train


def test_launch_train_stopped_and_resumed_equals_one_run(tmp_path,
                                                         monkeypatch, capsys):
    """A SIGTERM after step 4 (of 6) checkpoints and exits; a new run with
    the same arguments resumes there, skips the data pipeline to step 4,
    and ends with the parameters, moments and step of one uninterrupted
    6-step run, bit for bit."""
    from repro_torch.launch import train as launch_train

    args = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq",
            "16", "--log-every", "1", "--ckpt-every", "100"]
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")]) == 6

    real = launch_train.make_train_step

    def stopping(model, opt_cfg, microbatch=0):
        step = real(model, opt_cfg, microbatch=microbatch)
        calls = {"n": 0}

        def wrapped(*a):
            out = step(*a)
            calls["n"] += 1
            if calls["n"] == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    monkeypatch.setattr(launch_train, "make_train_step", stopping)
    b = str(tmp_path / "b")
    assert launch_train.main(args + ["--ckpt-dir", b]) == 4
    assert ckpt.latest_steps(b) == [4]
    monkeypatch.setattr(launch_train, "make_train_step", real)
    assert launch_train.main(args + ["--ckpt-dir", b]) == 6
    out = capsys.readouterr().out
    assert "SIGTERM: checkpointed and exiting" in out
    assert "resumed from step 4" in out
    assert out.count("[train] step 5 loss") == 2

    cfg, model = launch_train.build("llama3.2-1b", "smoke")
    p0 = model.init(torch.Generator().manual_seed(0))
    template = (p0, topt.adamw_init(p0))
    want, step_a, _ = ckpt.restore(str(tmp_path / "a"), template)
    got, step_b, extra = ckpt.restore(b, template)
    assert step_a == step_b == 6 and extra["data"]["step"] == 6
    for (k, w), (_, g) in zip(tree_leaves_with_path(want),
                              tree_leaves_with_path(got)):
        assert torch.equal(w, g), k


def test_launch_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "internvl2-2b",
                                  "mamba2-2.7b"])
def test_launch_train_runs_every_family(arch, capsys):
    """The MoE, VLM (zero patches) and SSM families train on the CPU."""
    from repro_torch.launch import train as launch_train

    assert launch_train.main(["--device", "cpu", "--arch", arch, "--steps",
                              "2", "--batch", "2", "--seq", "16",
                              "--log-every", "1"]) == 2
    losses = [float(line.split()[4]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


# ------------------------------------- K6 and K7's gradient on CUDA tensors


def test_flash_launch_carries_the_plain_gradient(monkeypatch):
    """``mha``'s CUDA route is an ``autograd.Function``: its output has a
    ``grad_fn`` and its backward gives the plain version's gradients (GQA:
    KV-head gradients summed over the group).  The launch is replaced by
    the plain version so that the Function runs on CPU tensors."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    monkeypatch.setattr(ops, "_launch", lambda q, k, v, causal, window,
                        softcap: attention_ref(q, k, v, causal=causal,
                                               window=window,
                                               softcap=softcap).detach())
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8)))
    opts = dict(causal=True, window=4, softcap=20.0)
    dout = torch.from_numpy(rng.standard_normal((2, 9, 4, 8)).astype(
        np.float32))
    grads = []
    for fn in (lambda *t: ops._Attention.apply(*t, *opts.values()),
               lambda *t: attention_ref(*t, **opts)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        assert out.grad_fn is not None
        out.backward(dout)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_launch_carries_the_plain_gradient(monkeypatch):
    """The same for ``ssd``'s ``autograd.Function``: gradients for x, dt, A,
    Bm, Cm and D from y alone (the final state's gradient is None) and
    from y and the final state."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    monkeypatch.setattr(ops, "_check", lambda *a: CPU)
    monkeypatch.setattr(ops, "_launch_simt", lambda x, dt, A, Bm, Cm, D,
                        chunk, dev: tuple(t.detach() for t in ssd_chunked(
                            x, dt, A, Bm, Cm, D, chunk)))
    rng = np.random.default_rng(5)
    B, S, nh, hd, ns = 2, 11, 3, 4, 5
    arrs = [rng.standard_normal((B, S, nh, hd)),
            np.log1p(np.exp(rng.standard_normal((B, S, nh)))),
            -np.exp(rng.standard_normal(nh) * 0.3),
            rng.standard_normal((B, S, ns)), rng.standard_normal((B, S, ns)),
            rng.standard_normal(nh)]
    inputs = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    dy = torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(
        np.float32))
    for use_final in (False, True):
        grads = []
        for fn in (lambda *t: ops._Scan.apply(*t, 4),
                   lambda *t: ssd_chunked(*t, 4)):
            leaves = [t.clone().requires_grad_(True) for t in inputs]
            y, final = fn(*leaves)
            assert y.grad_fn is not None
            loss = (y * dy).sum() + (final.sum() if use_final else 0.0)
            loss.backward()
            grads.append([t.grad for t in leaves])
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_gradient_stays_finite_where_the_decay_overflows():
    """A chunk whose decay spans more than ~88 in log space (here dt 6 and
    A -1 over chunks of 16: ~96): the JAX package's ``ssd_chunked`` masks
    ``exp(cs_i - cs_j)`` after the ``exp``, so its gradient is NaN; the
    port masks before it, with the same forward values (to 1e-5, float32)
    and a finite gradient for every input.  At mamba2-2.7b's chunk of 256
    the decay reaches ~170, which is where this showed on the card."""
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    rng = np.random.default_rng(0)
    B, S, nh, hd, ns, Q = 1, 32, 2, 4, 8, 16
    arrs = [rng.standard_normal((B, S, nh, hd)).astype(np.float32),
            np.full((B, S, nh), 6.0, np.float32),
            -np.ones(nh, np.float32),
            rng.standard_normal((B, S, ns)).astype(np.float32),
            rng.standard_normal((B, S, ns)).astype(np.float32),
            np.ones(nh, np.float32)]
    jgrads = jax.grad(lambda *a: jnp.sum(jax_ssd_chunked(*a, Q)[0]),
                      argnums=tuple(range(6)))(*map(jnp.asarray, arrs))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, _ = ssd_chunked(*leaves, Q)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jax_ssd_chunked(
            *map(jnp.asarray, arrs), Q)[0]), atol=1e-5, rtol=1e-5)
    y.sum().backward()
    for t in leaves:
        assert torch.isfinite(t.grad).all()


def test_a_train_steps_results_are_freed_when_dropped():
    """No reference cycle keeps a step's gradients, moments or parameters
    alive after the caller drops them (a cycle would hold gigabytes a step
    until the cyclic garbage collector ran): a dropped AdamW update and
    a dropped ``value_and_grad`` are gone at once."""
    import weakref

    from repro_torch.train.trainer import value_and_grad

    params = {"w": torch.ones(8, 4), "n": torch.ones(4)}
    grads = {"w": torch.full((8, 4), 0.5), "n": torch.full((4,), 0.5)}
    new_p, state, _ = topt.adamw_update(topt.AdamWConfig(), grads,
                                        topt.adamw_init(params), params)
    refs = [weakref.ref(new_p["w"]), weakref.ref(state.m["w"])]
    loss, g = value_and_grad(lambda p, b: (p["w"].sum() * p["n"]).sum(),
                             params, None)
    refs.append(weakref.ref(g["w"]))
    del new_p, state, g
    assert [r() for r in refs] == [None] * 3
