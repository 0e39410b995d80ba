"""Rank programs of ``tests/test_torch_distributed.py``: one lane per
``gloo`` CPU rank (``repro_torch.distributed``), and the same programs on
the stacked runtime in the test's own process.

Imports neither JAX nor the JAX package, so that spawned ranks load only
torch and the port.  The serving cases (the decode engine's device master
and the request-id master under a ServeCluster) run reduced llama3.2-1b.  Every case takes ``execution`` (``"vmap"``: the W
lanes stacked in this process; ``"mesh"``: one lane per rank, every rank
running the same call) and returns host data in the stacked layout, which
the test compares bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.core.dd.knapsack import random_instance
from repro_torch.core import ops as bulk_ops
from repro_torch.core.dd.parallel import parallel_solve
from repro_torch.core.lanes import StackedLanes
from repro_torch.core.master import RebalanceStats, hierarchical_superstep
from repro_torch.core.ops import QueueState, to_numpy
from repro_torch.core.policy import StealPolicy
from repro_torch.core.sharded_queue import (make_sharded_queues,
                                            sharded_superstep,
                                            vmapped_superstep)
from repro_torch.distributed import MeshStealRuntime, elastic, launch_runtime
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.runtime import FaultPlan
from repro_torch.runtime.telemetry import RoundRecord

W = 8
SPEC = torch.zeros((), dtype=torch.int32)
# tests/test_distributed.py's seed: three loaded lanes, ids from 1
SIZES = [40, 0, 0, 0, 25, 0, 3, 0]
PARITY = [(pod, backend, exchange) for pod in (None, 4)
          for backend in ("reference", "auto")
          for exchange in ("compact", "dense")]
# sharded_superstep against the stacked superstep, flat and in pods of 4:
# (pod_size, exchange)
SUPERSTEP = [(pod, exchange) for pod in (None, 4)
             for exchange in ("compact", "dense")]
# the relaxed backend and the sanitizer (check=True) on both layouts:
# (backend, check, pod_size, exchange)
CHECKED = [("relaxed", False, None, "compact"), ("relaxed", False, 4, "dense"),
           ("reference", True, None, "compact"), ("cuda", True, 4, "dense")]
# tests/test_distributed.py's Fig. 9 drain: 3,000 nodes, pops of 16
DAG = dict(n_nodes=3000, batch=16, fanout=4, capacity=1024,
           policy=dict(proportion=0.5, low_watermark=4, high_watermark=32,
                       max_steal=64))
# the resilience parity size (tests/_torch_fault.py): 600 nodes, rings
# of 256, max_steal 64, pods of 4
FAULT = dict(n_nodes=600, batch=16, fanout=4, capacity=256,
             policy=dict(proportion=0.5, low_watermark=4, high_watermark=32,
                         max_steal=64))
FLAT_PLAN = dict(kills=((3, 6),), delays=((5, 4, 4),), drops=(8,))
DEAD_POD_PLAN = dict(kills=((3, 6), (4, 10), (5, 10), (6, 10), (7, 10)),
                     delays=((1, 3, 2),), drops=(9,))
SOLVER = dict(n_items=10, seed=3, n_workers=W, explore_width=8, batch=4,
              capacity=1024)
ELASTIC_POL = dict(backend="reference", low_watermark=2, high_watermark=8,
                   max_steal=64)
# benchmarks/serve_decode.py's tiny mix on W lanes: reduced llama3.2-1b in
# float32, 28 requests (mix seed 0) in one burst, 2 slots a lane, so that
# queues form and lanes steal
DECODE = dict(n_requests=28, arrival=28, capacity=64, n_slots=2,
              max_prompt=8, max_new=8, page_size=4)


def parity_policy(exchange: str) -> StealPolicy:
    return StealPolicy(proportion=0.5, low_watermark=2, high_watermark=8,
                       max_steal=32, exchange=exchange)


def seed(rt) -> None:
    nxt = 1
    for i, n in enumerate(SIZES):
        if n:
            rt.push(i, torch.arange(nxt, nxt + n, dtype=torch.int32), n)
            nxt += n


def host(tree):
    return tree_map(lambda x: to_numpy(x) if isinstance(x, torch.Tensor)
                    else np.asarray(x), tree)


FIELDS = [f.name for f in dataclasses.fields(RoundRecord)]


def records(rt) -> list:
    """Telemetry round records as tuples of plain values, the port's
    :class:`RoundRecord` fields (read from either package's runtime)."""
    def plain(v):
        return tuple(int(x) for x in v) if np.ndim(v) else v
    return [tuple(plain(getattr(r, f)) for f in FIELDS)
            for r in rt.telemetry.rounds]


def state(rt) -> dict:
    """The runtime's host-visible state in the stacked layout."""
    q = host(rt.gathered_queues())
    return dict(buf=q.buf, lo=q.lo, size=q.size, rounds_run=rt.rounds_run,
                telemetry=records(rt),
                history=list(rt.controller.history) if rt.controller
                else None)


def items(rt) -> list:
    """The live item multiset of all lanes."""
    q = host(rt.gathered_queues())
    buf = q.buf
    cap = buf.shape[1]
    return sorted(int(buf[i][(q.lo[i] + j) % cap])
                  for i in range(len(q.lo)) for j in range(q.size[i]))


def parity_case(execution, pod_size, backend, exchange, mesh=None) -> dict:
    """tests/test_distributed.py's parity drive: ``round()``,
    ``run_fused(2)``, ``run_fused(3, until_drained=True)``."""
    rt = launch_runtime(W, 128, SPEC, execution=execution, mesh=mesh,
                        pod_size=pod_size, policy=parity_policy(exchange),
                        backend=backend,
                        device="cpu" if mesh is None else None)
    seed(rt)
    _, s1 = rt.round()
    _, s2 = rt.run_fused(2)
    _, s3, rounds = rt.run_fused(3, until_drained=True)
    return dict(stats=[host(s1), host(s2), host(s3)], rounds=rounds,
                resolved=rt.ops.resolved, **state(rt))


def _lane0(stats, pod_size) -> RebalanceStats:
    """Stacked-layout stats of one round in ``sharded_superstep``'s layout:
    lane 0's (pod 0, worker 0) view, counters ``(1,)``."""
    if pod_size is None:
        return RebalanceStats(*(f.reshape(-1) if f.dim() else f.reshape(1)
                                for f in stats))
    return stats._replace(
        sizes_before=stats.sizes_before[:pod_size],
        sizes_after=stats.sizes_after[::pod_size],
        n_transferred=stats.n_transferred[:1], n_steals=stats.n_steals[:1],
        bytes_moved=stats.bytes_moved[:1],
        n_transferred_xpod=stats.n_transferred_xpod.reshape(1),
        n_steals_xpod=stats.n_steals_xpod.reshape(1),
        bytes_moved_xpod=stats.bytes_moved_xpod.reshape(1))


def superstep_case(execution, pod_size, exchange, mesh=None) -> dict:
    """tests/test_sharded_superstep.py's drive: SIZES' items (ids from 1)
    on W lanes of 128 rows, three supersteps, through ``sharded_superstep``
    (``"mesh"``: this rank's lane, every rank calling it) or on the
    stacked lanes (``"vmap"``: ``vmapped_superstep``'s lane 0 flat,
    ``hierarchical_superstep`` in pods, each round's stats put in the
    layout of ``sharded_superstep``).  Returns the W lanes' rings and cursors and
    each round's stats."""
    pol = parity_policy(exchange)
    ops = bulk_ops.make_ops("auto")
    n = W if execution == "vmap" else 1
    first = 0 if execution == "vmap" else mesh.lane
    qs = make_sharded_queues(n, 128, SPEC, device="cpu")
    ids = np.concatenate([[0], np.cumsum(SIZES)]) + 1
    batch = torch.zeros((n, max(SIZES)), dtype=torch.int32)
    for i in range(n):
        k = SIZES[first + i]
        batch[i, :k] = torch.arange(ids[first + i], ids[first + i] + k)
    qs, _ = ops.push(qs, batch, torch.tensor(SIZES[first:first + n],
                                             dtype=torch.int32))
    if execution == "mesh":
        step = sharded_superstep(mesh, pol, pod_axis=mesh.axis_names[0]
                                 if pod_size else None, ops=ops)
    elif pod_size is None:
        vmapped = vmapped_superstep(pol, ops, device="cpu")

        def step(q):
            q, stats = vmapped(q)
            return q, RebalanceStats(*(f[0] for f in stats))
    else:
        def step(q):
            q, stats = hierarchical_superstep(q, pol, pod_size=pod_size,
                                              ops=ops, lanes=StackedLanes(W))
            return q, _lane0(stats, pod_size)
    rounds = []
    for _ in range(3):
        qs, stats = step(qs)
        rounds.append(host(_lane0(stats, None) if execution == "vmap"
                           and pod_size is None else stats))
    if execution == "mesh":
        lanes = mesh.lanes()
        qs = QueueState(lanes.all_gather(qs.buf), lanes.all_gather(qs.lo),
                        lanes.all_gather(qs.size))
    q = host(qs)
    return dict(buf=q.buf, lo=q.lo, size=q.size, stats=rounds)


def checked_case(execution, backend, check, pod_size, exchange,
                 mesh=None) -> dict:
    """``parity_case``'s drive on the relaxed backend or under the
    sanitizer, which checks every op and every round (the mesh's rounds on
    the gathered sizes and queues)."""
    rt = launch_runtime(W, 128, SPEC, execution=execution, mesh=mesh,
                        pod_size=pod_size, policy=parity_policy(exchange),
                        backend=bulk_ops.make_ops(backend, capacity=128,
                                                  max_steal=32, check=check),
                        device="cpu" if mesh is None else None)
    seed(rt)
    rt.round()
    rt.run_fused(2)
    rt.run_fused(3, until_drained=True)
    return dict(checked=rt.ops.checked, **state(rt))


def dag_body(ops, lanes, *, n_nodes, batch, fanout):
    """The Fig. 9 DAG body on the lanes held here, with the JAX body's
    worker-body collective (``lax.pmax`` of the carry: ``lanes.max``)."""
    def body(q, carry):
        q, nodes, n_popped = ops.pop_bulk(q, batch, batch, donate=True)
        w, dev = q.size.shape[0], q.size.device
        valid = (torch.arange(batch, dtype=torch.int32, device=dev)[None, :]
                 < n_popped[:, None])
        kids = (nodes[:, :, None] * fanout + 1
                + torch.arange(fanout, dtype=torch.int32, device=dev))
        live = valid[:, :, None] & (kids < n_nodes)
        flat, flive = kids.reshape(w, -1), live.reshape(w, -1)
        order = torch.argsort((~flive).to(torch.int32), dim=1, stable=True)
        flat = torch.where(flive.gather(1, order), flat.gather(1, order), 0)
        q, _ = ops.push(q, flat, flive.sum(1).to(torch.int32), donate=True)
        peak = lanes.max(carry)
        return q, carry + valid.sum(1).to(torch.int32) + 0 * peak
    return body


def dag_case(execution, cfg=DAG, *, plan=None, pod_size=None, rounds=0,
             mesh=None) -> dict:
    """Drain the DAG from one root on lane 0: ``rounds`` single rounds,
    then ``run_fused(16, until_drained=True)`` blocks."""
    rt = launch_runtime(W, cfg["capacity"], SPEC, execution=execution,
                        mesh=mesh, pod_size=pod_size,
                        policy=StealPolicy(backend="reference",
                                           **cfg["policy"]),
                        fault_plan=None if plan is None
                        else FaultPlan(**plan),
                        device="cpu" if mesh is None else None)
    rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    body = dag_body(rt.ops, rt.lanes, n_nodes=cfg["n_nodes"],
                    batch=cfg["batch"], fanout=cfg["fanout"])
    carry = torch.zeros((rt.lanes.n_local,), dtype=torch.int32)
    for _ in range(rounds):
        carry, _ = rt.round(body, carry)
    ran = rounds
    while rt.total_size() > 0 and ran < 500:
        carry, _, r = rt.run_fused(16, body, carry, until_drained=True)
        ran += r
    return dict(carry=to_numpy(rt.lanes.all_gather(carry)), ran=ran,
                summary=rt.telemetry.summary(), **state(rt))


def solver_case(execution) -> dict:
    cfg = dict(SOLVER)
    inst = random_instance(cfg.pop("n_items"), seed=cfg.pop("seed"))
    opt, st = parallel_solve(inst, execution=execution, device="cpu", **cfg)
    return dict(optimum=opt, **{k: st[k] for k in (
        "supersteps", "explored", "transferred", "per_worker_explored",
        "telemetry", "execution", "ring_refused_rows", "ring_peak_rows",
        "per_worker_ring_peak")})


def elastic_seed(rt, lanes) -> None:
    rng = np.random.default_rng(5)
    for w in range(lanes):
        n = int(rng.integers(5, 30))
        rt.push(w, torch.arange(w * 100, w * 100 + n, dtype=torch.int32), n)


def padded_case(execution, mesh=None) -> dict:
    """A runtime padded from 6 to 8 lanes: rounds, a live shrink of lane
    1, rounds, a live grow of two lanes, rounds."""
    rt = elastic.padded_runtime(6, 128, SPEC, w_max=W, execution=execution,
                                mesh=mesh, policy=StealPolicy(**ELASTIC_POL),
                                device="cpu" if mesh is None else None)
    elastic_seed(rt, 6)
    before = items(rt)
    rt.run_fused(4)
    elastic.live_shrink(rt, [1])
    rt.run_fused(4)
    revived = elastic.live_grow(rt, 2)
    rt.run_fused(4)
    return dict(before=before, items=items(rt), revived=revived,
                live=elastic.n_live(rt), faults=rt.telemetry.fault_log,
                **state(rt))


def resize_case(execution, rt=None) -> dict:
    """``shrink`` 8 -> 6 lanes (dropping 1 and 5) and ``grow`` back by 2,
    with rounds between; on a mesh ranks 6 and 7 hold no runtime while the
    mesh is small."""
    if rt is None:
        rt = launch_runtime(W, 128, SPEC, execution=execution,
                            policy=StealPolicy(**ELASTIC_POL),
                            fault_plan=FaultPlan(), device="cpu")
    elastic_seed(rt, W)
    before = items(rt)
    for _ in range(2):
        rt.round()
    rt = elastic.shrink(rt, [1, 5])
    small = None if rt is None else dict(n=rt.n_workers, items=items(rt),
                                         sizes=rt.sizes().tolist())
    rt = elastic.grow(rt, 2)
    for _ in range(4):
        rt.round()
    return dict(before=before, small=small, items=items(rt),
                sizes=rt.sizes().tolist(), n=rt.n_workers,
                summary=rt.telemetry.summary(),
                kind=type(rt).__name__, **state(rt))


def snapshot_case(execution, save_dir=None, restore_dir=None,
                  pod_size=None) -> dict:
    """Restore from ``restore_dir`` (or seed afresh), run 2 rounds, save
    to ``save_dir``, run 3 more."""
    rt = launch_runtime(W, 128, SPEC, execution=execution,
                        pod_size=pod_size, policy=parity_policy("compact"),
                        fault_plan=FaultPlan(), device="cpu")
    if restore_dir is not None:
        rt.restore_state(restore_dir)
    else:
        seed(rt)
    for _ in range(2):
        rt.round()
    saved = state(rt)
    if save_dir is not None:
        rt.save_state(save_dir)
    rt.run_fused(3)
    return dict(saved=saved, **state(rt))


@functools.lru_cache(maxsize=1)
def reduced_llama():
    """Reduced llama3.2-1b in float32 with seed-0 parameters on the CPU."""
    from repro_torch import configs
    from repro_torch.models.zoo import build_model

    cfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                              compute_dtype="float32")
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def decode_mix(n: int, seed: int = 0) -> list:
    """benchmarks/serve_decode.py's _request_mix (prompts up to 8 tokens,
    min(1 + geometric(0.35), 8) new tokens)."""
    rng = np.random.default_rng(seed)
    mix = []
    for _ in range(n):
        plen = int(rng.integers(1, DECODE["max_prompt"] + 1))
        out = int(min(1 + rng.geometric(0.35), DECODE["max_new"]))
        mix.append((list(map(int, rng.integers(1, 500, size=plen))), out))
    return mix


def decode_case(execution, steal, mesh=None) -> dict:
    """The decode engine's device master on W lanes, steal-balanced, with
    only queued requests stolen or also in-flight ones migrated: what a
    drain served, its stamps, its waves and its counters."""
    from repro_torch.serve.decode import DecodeCluster, DecodePolicy
    from repro_torch.serve.scheduler import Request

    model, params = reduced_llama()
    cfg = DECODE
    pol = DecodePolicy(n_slots=cfg["n_slots"], max_prompt=cfg["max_prompt"],
                       max_new=cfg["max_new"], page_size=cfg["page_size"],
                       steal=steal)
    c = DecodeCluster(model, params, policy=pol, n_lanes=W,
                      capacity=cfg["capacity"], execution=execution,
                      mesh=mesh, straggler_threshold=float("inf"),
                      device="cpu" if mesh is None else None)
    reqs = [Request(prompt=p, max_new=m, rid=i)
            for i, (p, m) in enumerate(decode_mix(cfg["n_requests"]))]
    a = cfg["arrival"]
    for i in range(0, len(reqs), a):
        c.submit(reqs[i:i + a])
        c.step()
    c.run_until_drained(max_steps=500)
    st = c.stats()
    return dict(outputs=[(r.rid, list(r.output)) for r in c.done],
                stamps=[(r.rid, r.admit, r.first, r.finish, r.tokens)
                        for r in c.telemetry.requests],
                waves=[(list(map(int, w.loads)), w.served, w.tokens,
                        w.migrated) for w in c.telemetry.waves],
                rounds=c.rounds, stolen=c.stolen, migrated=c.migrated,
                stats={k: st[k] for k in ("loads", "queued", "pending",
                                          "served", "stalls", "kv_tokens",
                                          "proportion", "backend")},
                telemetry=records(c.runtime))


def admission_case(execution, mesh=None) -> dict:
    """The request-id master (RuntimeAdmissionMaster) on W lanes through
    admission, waves, rebalancing, eviction and re-admission, then a
    ServeCluster of W replicas draining on it."""
    from repro_torch.distributed import RuntimeAdmissionMaster
    from repro_torch.serve.engine import Replica, ServeCluster
    from repro_torch.serve.scheduler import Request

    dev = "cpu" if mesh is None else None
    master = RuntimeAdmissionMaster(W, capacity=32, execution=execution,
                                    mesh=mesh, device=dev)
    seen = []
    for i in range(3):
        seen.append(master.submit([Request(prompt=[1], max_new=1,
                                           rid=10 * i + j)
                                   for j in range(9)]))
    seen.append([r.rid for r in master.replicas[0].pop_wave(4)])
    seen.append(master.rebalance_many(3))
    seen.append(master.stats()["queued"])
    seen.append(master.evict(1))
    master.readmit(1)
    seen.append(master.rebalance())
    st = master.stats()
    seen.append({k: st[k] for k in ("loads", "queued", "completed",
                                    "evicted", "stolen", "rounds",
                                    "proportion")})
    seen.append(master.telemetry.summary()["faults"])

    model, params = reduced_llama()
    reps = [Replica(model, params, wave_size=2, max_seq=12)
            for _ in range(W)]
    reps[0].speed = 0.5
    cluster = ServeCluster(reps, execution=execution, admission_capacity=32,
                           straggler_threshold=float("inf"),
                           master=None if mesh is None else
                           RuntimeAdmissionMaster(W, capacity=32,
                                                  execution="mesh",
                                                  mesh=mesh))
    rng = np.random.default_rng(1)
    cluster.submit([Request(prompt=list(map(int, rng.integers(1, 500, 5))),
                            max_new=2, rid=100 + j) for j in range(24)])
    done = cluster.run_until_drained()
    return dict(seen=seen, served=[(r.rid, list(r.output)) for r in done],
                master=records(cluster.master.runtime),
                completed=cluster.master.stats()["completed"],
                stolen=cluster.master.stolen)


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def refusals(flat, pods) -> dict:
    """launch_runtime's and make_worker_mesh's refusals, and a mesh over
    the first half of the ranks."""
    out = {
        "execution": _raises(lambda: launch_runtime(
            W, 64, SPEC, execution="threads")),
        "size": _raises(lambda: launch_runtime(
            4, 64, SPEC, execution="mesh", mesh=flat)),
        "flat_with_pods": _raises(lambda: launch_runtime(
            W, 64, SPEC, execution="mesh", mesh=flat, pod_size=4)),
        "pods_without": _raises(lambda: launch_runtime(
            W, 64, SPEC, execution="mesh", mesh=pods)),
        "device": _raises(lambda: launch_runtime(
            W, 64, SPEC, execution="mesh", mesh=flat, device="cpu")),
        "vmap_mesh": _raises(lambda: launch_runtime(
            W, 64, SPEC, execution="vmap", mesh=flat)),
        "derived": _raises(lambda: MeshStealRuntime(
            pods, 64, SPEC, pod_size=4)),
        "oversized": _raises(lambda: make_worker_mesh(10_000)),
        "indivisible": _raises(lambda: make_worker_mesh(W, pod_size=3)),
    }
    rt = launch_runtime(W, 64, SPEC, execution="mesh", mesh=pods,
                        pod_size=4)
    out["pinned"] = (rt.pod_size, rt.n_workers, rt.lanes.n_local)
    half = make_worker_mesh(4, device="cpu")  # every rank calls it
    out["half_member"] = half.member
    out["outside"] = _raises(lambda: MeshStealRuntime(half, 64, SPEC))
    return out


def rank_program(rank: int, restore_dir: str, save_dir: str) -> dict:
    """Every mesh case, in one order on every rank."""
    del rank
    flat = make_worker_mesh(W, device="cpu")
    pods = make_worker_mesh(W, pod_size=4, device="cpu")
    out = {"parity": {case: parity_case(
        "mesh", *case, mesh=pods if case[0] else flat) for case in PARITY}}
    out["checked"] = {case: checked_case(
        "mesh", *case, mesh=pods if case[2] else flat) for case in CHECKED}
    out["superstep"] = {case: superstep_case(
        "mesh", *case, mesh=pods if case[0] else flat) for case in SUPERSTEP}
    out["dag"] = dag_case("mesh", mesh=flat)
    out["fault_flat"] = dag_case("mesh", FAULT, plan=FLAT_PLAN, rounds=2,
                                 mesh=flat)
    out["fault_pods"] = dag_case("mesh", FAULT, plan=DEAD_POD_PLAN,
                                 pod_size=4, rounds=2, mesh=pods)
    out["solver"] = solver_case("mesh")
    out["padded"] = padded_case("mesh", mesh=flat)
    out["resize"] = resize_case("mesh", launch_runtime(
        W, 128, SPEC, execution="mesh", mesh=flat,
        policy=StealPolicy(**ELASTIC_POL), fault_plan=FaultPlan()))
    out["snap_saved"] = snapshot_case("mesh", save_dir=save_dir)
    out["snap_restored"] = snapshot_case("mesh", restore_dir=restore_dir,
                                         pod_size=4)
    out["refusals"] = refusals(flat, pods)
    out["decode"] = {steal: decode_case("mesh", steal, mesh=flat)
                     for steal in ("queue", "migrate")}
    out["admission"] = admission_case("mesh", mesh=flat)
    return out


def program(restore_dir: str, save_dir: str):
    return functools.partial(rank_program, restore_dir=restore_dir,
                             save_dir=save_dir)


def card_backlog(rank: int, execution: str = "mesh") -> dict:
    """2 lanes of 1,024 rows on the card's kernel routing, lane 0 holding
    500 items, 4 supersteps under each exchange: the W lanes' state and
    this process's K1 / K4 / K2 launches."""
    from repro_torch.kernels.queue_push.ops import push_scatter
    from repro_torch.kernels.queue_steal.ops import steal_gather
    from repro_torch.kernels.queue_transfer.ops import transfer_splice

    del rank
    out = {}
    for exchange in ("compact", "dense"):
        rt = launch_runtime(
            2, 1024, SPEC, execution=execution, backend="cuda",
            policy=StealPolicy(proportion=0.5, low_watermark=1,
                               high_watermark=8, max_steal=256,
                               exchange=exchange),
            device=None if execution == "mesh" else "cuda")
        rt.push(0, torch.arange(500, dtype=torch.int32), 500)
        counters = (steal_gather, transfer_splice, push_scatter)
        for fn in counters:
            fn.launches = 0
        rt.run_fused(4)
        out[exchange] = dict(state(rt), launches=[fn.launches
                                                  for fn in counters])
    return out
