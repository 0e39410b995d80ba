"""The port's SSM family (``SSMLM``, ``HybridLM``) against the JAX package
on the CPU, on reduced mamba2-2.7b and zamba2-7b.

Parameters are made by the JAX package and carried over with
``params_from_numpy``; tokens are drawn with numpy.  Float32 compute must
agree to ``atol = rtol = 1e-4`` on logits and SSD states; bfloat16
compute, where the two frameworks round at different places, to ``2e-2``
(``tests/test_serve.py``'s tolerance).  The conv buffers hold projection
outputs, matrix products whose sums XLA and PyTorch order differently, so
they are held to the same tolerances, not bit for bit; ``grow_cache`` on
one input cache must give the same bits.  On the CPU the prefill scan is
K7's plain version (``ssd_chunked``) and the hybrid's prefill attention
K6's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import StealPolicy as JaxPolicy
from repro.models import build_model as jax_build_model
from repro.serve.engine import Replica as JaxReplica
from repro.serve.engine import ServeCluster as JaxCluster
from repro.serve.scheduler import AdmissionMaster as JaxMaster
from repro.serve.scheduler import Request as JaxRequest
from repro_torch import configs
from repro_torch.core.policy import StealPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.hybrid import HybridLM, SSMLM
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.serve.engine import Replica, ServeCluster
from repro_torch.serve.scheduler import AdmissionMaster, Request

from _torch_parity import assert_same, tree_np, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
ARCHS = ["mamba2-2.7b", "zamba2-7b"]
SSM_PARTS = {"mamba2-2.7b": ("ssm",),
             "zamba2-7b": ("grouped_ssm", "tail_ssm")}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The JAX package's parameters (float32, whatever the compute dtype),
    made once per arch."""
    return jax_build_model(jconfigs.reduced(jconfigs.get(arch))).init(
        jax.random.PRNGKey(0))


def _models(arch, compute_dtype):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                               compute_dtype=compute_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = _jax_params(arch)
    return jm, tm, jp, params_from_numpy(tree_np(jp), CPU)


def _cache_to_torch(cache):
    out = params_from_numpy(tree_np({k: v for k, v in cache.items()
                                     if k != "pos"}), CPU)
    out["pos"] = int(cache["pos"])
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _check_caches(jcache, tcache, arch, tol):
    assert tcache["pos"] == int(jcache["pos"])
    for part in SSM_PARTS[arch]:
        want, got = jcache[part], tcache[part]
        assert tuple(got["state"].shape) == want["state"].shape
        assert got["state"].dtype == torch.float32
        assert str(got["conv_buf"].dtype)[6:] == str(want["conv_buf"].dtype)
        _close(got["conv_buf"], want["conv_buf"], tol, f"{part}.conv_buf")
        _close(got["state"], want["state"], tol, f"{part}.state")
    if arch == "zamba2-7b":
        for kv in ("k", "v"):
            _close(tcache["shared_attn"][kv], jcache["shared_attn"][kv], tol,
                   f"shared_attn.{kv}")


def test_build_model_builds_the_ssm_family():
    assert isinstance(build_model(configs.get("mamba2-2.7b")), SSMLM)
    assert isinstance(build_model(configs.get("zamba2-7b")), HybridLM)


@pytest.mark.parametrize("arch", ARCHS)
def test_initializers_follow_the_jax_layout(arch):
    cfg = configs.reduced(configs.get(arch))
    tparams = build_model(cfg).init(torch.Generator().manual_seed(0))
    jparams = _jax_params(arch)
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
            == jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            tparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch):
    jm, tm, jp, tp = _models(arch, "float32")
    toks = np.random.default_rng(3).integers(1, 512, (2, 37)).astype(np.int32)
    want = jm.forward(jp, jnp.asarray(toks))
    got = tm.forward(tp, torch.from_numpy(toks))
    _close(got, want, 1e-4, "forward")


# S = 16 is one whole chunk of the reduced configs; S = 37 leaves a
# ragged last chunk, which the JAX package pads with dt = 0.
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,compute_dtype", [
    (16, "float32"), (37, "float32"), (37, "bfloat16")])
def test_prefill_grow_and_decode_match(arch, S, compute_dtype):
    jm, tm, jp, tp = _models(arch, compute_dtype)
    toks = np.random.default_rng(S).integers(
        1, tm.cfg.vocab_size, (2, S + 3)).astype(np.int32)
    tol = 1e-4 if compute_dtype == "float32" else 2e-2

    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S]))
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl, tol, "prefill logits")
    _check_caches(jcache, tcache, arch, tol)

    # grow_cache: the same input cache gives the same bits.
    target = S + 8
    jgrown = jm.grow_cache(jcache, target)
    mine = tm.grow_cache(_cache_to_torch(jcache), target)
    for a, b in zip(jax.tree.leaves({k: v for k, v in jgrown.items()
                                     if k != "pos"}),
                    jax.tree.leaves({k: v for k, v in mine.items()
                                     if k != "pos"})):
        assert_same(np.asarray(a), b, "grow_cache")

    jcache, tcache = jgrown, tm.grow_cache(tcache, target)
    for t in range(3):
        step = toks[:, S + t:S + t + 1]
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(step))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step))
        _close(tl, jl, tol, f"decode step {t}")
    _check_caches(jcache, tcache, arch, tol)
    assert tcache["pos"] == S + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_matches_the_jax_layout(arch):
    jm, tm, _, _ = _models(arch, "bfloat16")
    want = jm.make_cache(3, 40)
    got = tm.make_cache(3, 40, device=CPU)
    assert got["pos"] == int(want["pos"]) == 0
    wl, gl = (jax.tree.leaves({k: v for k, v in c.items() if k != "pos"})
              for c in (want, got))
    assert [(a.shape, str(a.dtype)) for a in wl] == [
        (tuple(b.shape), str(b.dtype)[6:]) for b in gl]
    assert not any(bool(b.any()) for b in gl)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cluster_outputs_match_per_request(arch):
    """Equal-length prompts (so a request's tokens do not depend on its
    wave mates, see ``tests/test_torch_serve.py``): the port's tokens equal
    the JAX package's, request by request."""
    jm, tm, jp, tp = _models(arch, "float32")
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 512, 10))) for _ in range(10)]
    budgets = [int(rng.integers(2, 6)) for _ in prompts]
    policy = dict(proportion=0.5, low_watermark=1, high_watermark=2)

    def cluster(replica, cluster_cls, master_cls, policy_cls, model, params):
        reps = [replica(model, params, wave_size=4, max_seq=20)
                for _ in range(2)]
        reps[0].speed = 0.25   # straggler: waves of one
        return cluster_cls(reps, master_cls(2, policy=policy_cls(**policy)))

    mine = cluster(Replica, ServeCluster, AdmissionMaster, StealPolicy,
                   tm, tp)
    theirs = cluster(JaxReplica, JaxCluster, JaxMaster, JaxPolicy, jm, jp)
    mine.submit([Request(prompt=p, max_new=n, rid=i)
                 for i, (p, n) in enumerate(zip(prompts, budgets))])
    theirs.submit([JaxRequest(prompt=p, max_new=n, rid=i)
                   for i, (p, n) in enumerate(zip(prompts, budgets))])
    got = {r.rid: r.output for r in mine.run_until_drained()}
    want = {r.rid: r.output for r in theirs.run_until_drained()}
    assert sorted(got) == list(range(len(prompts)))
    assert got == want
    st = mine.master.stats()
    assert st["stolen"] > 0 and sum(st["completed"]) == len(prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_ssm_family_on_the_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "6", "--max-new", "3",
                              "--straggle"]) == 0
    assert "[serve] 6/6 requests, 18 tokens" in capsys.readouterr().out
