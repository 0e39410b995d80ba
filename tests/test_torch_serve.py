"""The port's wave-serving path against the JAX package on the CPU.

``ServeCluster`` runs reduced llama3.2-1b in float32 compute with the JAX
package's parameters (carried over with ``params_from_numpy``) on
equal-length prompts: a wave left-pads its prompts to the longest, and the
model attends to that padding, so with unequal prompts a request's tokens
would depend on its wave mates, which the straggler monitor's wall clock
chooses.  With equal lengths every request's greedy tokens are its own,
and they must equal the JAX package's, request by request.
"""

import dataclasses

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
from repro.serve.kv_cache import cache_tokens as jax_cache_tokens
from repro.serve.kv_cache import pad_cache as jax_pad_cache
from repro.serve.scheduler import AdmissionMaster as JaxMaster
from repro.serve.scheduler import Request as JaxRequest
from repro_torch import configs
from repro_torch.core.policy import StealPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.serve.engine import Replica, ServeCluster
from repro_torch.serve.kv_cache import cache_tokens, pad_cache
from repro_torch.serve.scheduler import AdmissionMaster, Request

from _torch_parity import assert_same, tree_np, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
POLICY = dict(proportion=0.5, low_watermark=1, high_watermark=2)


def _llama(compute_dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("llama3.2-1b")),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                               compute_dtype=compute_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(tree_np(jp), CPU)


def test_serve_cluster_outputs_match_per_request():
    jm, tm, jp, tp = _llama()
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 512, 10))) for _ in range(14)]
    budgets = [int(rng.integers(2, 7)) for _ in prompts]

    def cluster(replica, cluster_cls, master_cls, policy_cls, model, params):
        reps = [replica(model, params, wave_size=4, max_seq=24)
                for _ in range(2)]
        reps[0].speed = 0.25   # straggler: waves of one
        return cluster_cls(reps, master_cls(2, policy=policy_cls(**POLICY)))

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
    assert all(len(got[i]) == n for i, n in enumerate(budgets))
    st = mine.master.stats()
    assert st["stolen"] > 0 and sum(st["completed"]) == len(prompts)
    tele = mine.telemetry.summary()
    assert tele["served"] == len(prompts)
    assert tele["tokens"] == sum(r.tokens_generated for r in mine.replicas)


def test_replica_wave_left_pads_like_the_jax_package():
    """One wave of unequal prompts (so left padding is in play) gives the
    JAX package's greedy tokens."""
    jm, tm, jp, tp = _llama()
    prompts = [[5, 9, 200, 7], [11, 3], [400, 1, 2, 3, 4, 5]]
    mine = Replica(tm, tp, wave_size=4, max_seq=16).run_wave(
        [Request(prompt=p, max_new=5) for p in prompts])
    theirs = JaxReplica(jm, jp, wave_size=4, max_seq=16).run_wave(
        [JaxRequest(prompt=p, max_new=5) for p in prompts])
    assert [r.output for r in mine] == [r.output for r in theirs]


def test_pad_cache_and_cache_tokens_match():
    jm, tm, jp, tp = _llama()
    toks = np.random.default_rng(1).integers(1, 512, (2, 9)).astype(np.int32)
    _, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    tcache = params_from_numpy(tree_np({k: v for k, v in jcache.items()
                                        if k != "pos"}), CPU)
    tcache["pos"] = 9
    jgrown, tgrown = jax_pad_cache(jcache, 20), pad_cache(tcache, 20)
    for kv in ("k", "v"):
        assert_same(np.asarray(jgrown["g0"][kv]), tgrown["g0"][kv], kv)
    assert cache_tokens(tgrown) == jax_cache_tokens(jgrown) == 2 * 20
    assert pad_cache(tgrown, 5)["g0"]["k"] is tgrown["g0"]["k"]
    cross = {"cross": {"k": torch.zeros(1, 1, 3, 1, 2)}}
    assert pad_cache(cross, 8)["cross"]["k"].shape[2] == 3


def test_device_admission_waits_for_its_master(tmp_path):
    """``execution="vmap"`` / ``"mesh"`` put the admission queues on
    executor lanes behind a ``RuntimeAdmissionMaster``: stacked on the
    replicas' device, or one lane per rank (here a world of one gloo
    rank); both serve every request in full."""
    import torch.distributed as dist

    from repro_torch.distributed import RuntimeAdmissionMaster

    _, tm, _, tp = _llama()

    def serve(n_replicas, execution):
        reps = [Replica(tm, tp, wave_size=2, max_seq=16)
                for _ in range(n_replicas)]
        cluster = ServeCluster(reps, execution=execution,
                               admission_capacity=16,
                               straggler_threshold=float("inf"))
        assert isinstance(cluster.master, RuntimeAdmissionMaster)
        assert cluster.master.execution == execution
        cluster.submit([Request(prompt=[3, 4, 5, 6], max_new=3)
                        for _ in range(5)])
        done = cluster.run_until_drained()
        assert len(done) == 5 and all(len(r.output) == 3 for r in done)
        return cluster.master.stats()

    st = serve(2, "vmap")
    assert sum(st["completed"]) == 5 and st["backend"] == "cuda"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        st = serve(1, "mesh")
    finally:
        dist.destroy_process_group()
    assert st["completed"] == [5] and st["execution"] == "mesh"


def test_launcher_serves_on_the_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "6",
                              "--max-new", "3", "--straggle"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 6/6 requests, 18 tokens" in out
    for execution, steal in (("vmap", "queue"), ("host", "migrate")):
        assert launch_serve.main(["--device", "cpu", "--decode",
                                  "--requests", "10", "--replicas", "2",
                                  "--execution", execution,
                                  "--steal", steal]) == 0
        out = capsys.readouterr().out
        assert "[serve.decode] 10/10 requests" in out
        assert f"({execution}, steal={steal}, on cpu)" in out
