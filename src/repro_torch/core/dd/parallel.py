"""Master-worker parallel DD branch-and-bound on the lock-free bulk queues
(PyTorch port of ``repro.core.dd.parallel``).

W workers each own a private subproblem queue; exploring a subproblem
generates children in BULK (one push for all lanes); the virtual master
(``core.master.superstep``) observes queue sizes and bulk-steals
proportionally from busy workers to feed drained ones — the
single-stealer, watermark-gated policy of §II.B.

The solver runs on the runtime :func:`repro_torch.distributed.
launch_runtime` builds: the W lanes stacked on one device
(``execution="vmap"``) or one lane per rank of a ``torch.distributed``
mesh (``execution="mesh"``).  Its worker body sees the lanes its process
holds (all W, or one) and drives the runtime's resolved
:class:`~repro_torch.core.ops.BulkOps` backend and lane collectives, so
on the ``"cuda"`` routing each superstep is, on each process:

  1. ops.pop_bulk(E)      — one K3 launch for the payload tree, all held
                            lanes
  2. explore_batch        — restricted/relaxed DD bounds + exact frontier
                            for the held lanes' x E popped subproblems:
                            one launch of the fused DD explore (K5's
                            redesign)
  3. incumbent            — ``lanes.max`` over all W lanes (the JAX
                            package's ``lax.pmax``; a max over the stack,
                            or an all-reduce on a mesh)
  4. prune + compact      — children of dominated nodes are dropped
  5. ops.push(children)   — one K2 launch for the payload tree, in place;
                            the rows a full ring refused and each lane's
                            size after it kept in the carry (3 launches)
  6. master.superstep     — K1 window + K4 splice (appended by the runtime)

``fused_rounds`` supersteps run per :meth:`StealRuntime.run_fused` block,
with one host read-back per block.  A refused row is a lost subproblem:
a solve that refused one says so with a :class:`RingOverflowWarning`.
Each step is a host span (:func:`repro_torch.obs.phase.span`:
``repro.pop``, ``repro.explore``, ``repro.prune``, ``repro.push``) inside
the runtime's ``repro.worker_body``, and the solve is ``repro.solve``.

The instance's weights and profits ride in the carry, one row a lane,
so that the worker body reads no tensor but its queues and its carry.
Its key (``_graph_key``) then names all else that fixes its work, and on
stacked lanes on a CUDA device the runtime replays each block as one
CUDA graph captured once per geometry in the process
(:mod:`repro_torch.runtime.block_graph`): a series of instances of one
geometry is captured once and replayed for every later block.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from repro_torch._tree import resolve_device
from repro_torch.core.dd.bnb import Subproblem, explore_batch
from repro_torch.core.dd.diagram import NEG
from repro_torch.core.dd.knapsack import Knapsack
from repro_torch.core.ops import BulkOps, QueueState
from repro_torch.core.policy import StealPolicy
from repro_torch.distributed.launch import launch_runtime
from repro_torch.obs.phase import span

__all__ = ["parallel_solve", "RingOverflowWarning"]

I32 = torch.int32


class RingOverflowWarning(RuntimeWarning):
    """A full ring refused children of a solve: those subproblems are
    lost, so the optimum it returned is not proven.  Turn it into an error
    with ``warnings.simplefilter("error", RingOverflowWarning)``."""


def _item_spec():
    z = torch.zeros((), dtype=I32)
    return {"layer": z, "state": z, "value": z}


def _items_carry(inst: Knapsack, lanes, dev: torch.device) -> dict:
    """The carry's ``weights`` and ``profits``: the instance's items, one
    ``(n,)`` int32 row for each lane this process holds."""
    return {k: torch.tensor(getattr(inst, k), dtype=I32, device=dev)
            .expand(lanes.n_local, inst.n) for k in ("weights", "profits")}


def _make_worker_body(weights, profits, ops: BulkOps, lanes, *,
                      explore_width: int, batch: int, n_vars: int):
    """The solver's slice of a superstep, on the lanes this process
    holds.  Besides the incumbent and the explored count, the carry keeps
    two ring counters per lane: ``ring_refused``, the children a full ring
    refused (a lost subproblem each), and ``ring_peak``, the largest size
    after a push.

    The body reads the instance's items, ``weights`` and ``profits``, from
    the carry's leaves of those names (:func:`_items_carry`), so that a
    block replayed from a CUDA graph reads each solve's own; the two
    arguments stay first, where the benchmark's wrappers of this function
    (``bench/rings.py``) pass them.  With the runtime's own
    :class:`BulkOps` the body carries ``_graph_key``, so that its blocks
    can be replayed.  The key holds the ``explore_batch`` it calls, so a
    body around another explore is captured apart."""

    def body(q: QueueState, carry):
        w = q.size.shape[0]
        # 1. bulk pop up to `batch` subproblems per lane
        with span("pop"):
            q, items, n_popped = ops.pop_bulk(q, batch, batch, donate=True)
            explored = carry["explored"] + n_popped
            rows = torch.arange(batch, dtype=I32, device=q.size.device)
            valid = rows[None, :] < n_popped[:, None]           # (W, E)
            subs = Subproblem(layer=items["layer"].reshape(-1),
                              state=items["state"].reshape(-1),
                              value=items["value"].reshape(-1))

        # 2. explore all W x E subproblems in one batch (span
        # ``repro.explore``)
        out = explore_batch(subs, valid.reshape(-1), carry["weights"][0],
                            carry["profits"][0], width=explore_width,
                            n_vars=n_vars)

        with span("prune"):
            # 3. global incumbent: max over lanes, every lane gets it
            local_best = torch.maximum(
                carry["incumbent"], out["primal"].reshape(w, batch).amax(-1))
            incumbent = lanes.max(local_best)

            # 4. prune: a subproblem's children survive iff dual > incumbent
            keep = (out["dual"].reshape(w, batch)
                    > incumbent[:, None])[..., None]
            ch = out["children"]
            # (W, E, width)
            live = keep & (ch.layer.reshape(w, batch, -1) >= 0)
            flive = live.reshape(w, -1)
            # compact live children to the front of each lane (one stable
            # sort on an int key, as jnp.argsort(~flive) orders the bools)
            order = torch.argsort((~flive).to(I32), dim=1, stable=True)
            flat = {k: getattr(ch, k).reshape(w, -1).gather(1, order)
                    for k in ("layer", "state", "value")}
            n_children = flive.sum(1).to(I32)

        # 5. bulk push (step 6, the superstep, is appended by the runtime)
        with span("push"):
            q, pushed = ops.push(q, flat, n_children, donate=True)
            refused = carry["ring_refused"] + (n_children - pushed)
            peak = torch.maximum(carry["ring_peak"], q.size)
        return q, {"incumbent": incumbent, "explored": explored,
                   "ring_refused": refused, "ring_peak": peak,
                   "weights": carry["weights"], "profits": carry["profits"]}

    if isinstance(ops, BulkOps):
        body._graph_key = (explore_width, batch, n_vars, explore_batch)
    return body


def parallel_solve(inst: Knapsack, *, n_workers: int = 8,
                   explore_width: int = 16, batch: int = 8,
                   capacity: int = 4096, policy: StealPolicy | None = None,
                   max_supersteps: int = 10_000, adaptive: bool = True,
                   backend: str | BulkOps | None = None,
                   fused_rounds: int = 8,
                   execution: str = "vmap",
                   device=None) -> Tuple[int, dict]:
    """Solve on W lanes: stacked on one device with ``execution="vmap"``
    (the counterpart of the JAX package's vmapped lanes), or one lane per
    rank with ``execution="mesh"``, where every rank of an initialised
    process group calls this and gets the same result (the SPMD contract
    of :mod:`repro_torch.distributed.executor`).  ``device=None`` means
    CUDA (each rank's own device on a mesh), and raises without it; the
    tests pass ``device="cpu"``.  Both modes run the same round and return
    the same results.  ``backend`` overrides the routing of every queue
    op; by default ``policy.backend`` (``"auto"``) decides.
    ``fused_rounds > 1`` advances up to that many supersteps per
    read-back.

    Returns (optimum, stats); ``stats["telemetry"]`` carries the runtime's
    per-round rebalancing summary, ``stats["backend"]`` the resolved
    routing (``"cuda"`` for the kernels), ``stats["ring_refused_rows"]``
    the rows full rings refused (summed over the lanes),
    ``stats["per_worker_ring_peak"]`` each lane's largest size after a
    push, and ``stats["ring_peak_rows"]`` the largest lane size seen,
    after a push on the device or after a splice on the host.
    ``stats["graph_captures"]``, ``stats["graph_replays"]`` and
    ``stats["graph_eager_blocks"]`` count this solve's ``run_fused``
    blocks captured, replayed as a CUDA graph and issued eager.  Warns with
    :class:`RingOverflowWarning` when a ring refused a row: the subproblem
    is lost and the optimum not proven.
    """
    policy = policy or StealPolicy(proportion=0.5, high_watermark=4,
                                   low_watermark=0,
                                   max_steal=min(capacity, 1024))
    with span("solve"):
        with span("launch_runtime"):
            runtime = launch_runtime(
                n_workers, capacity, _item_spec(), execution=execution,
                policy=policy, adaptive=adaptive, backend=backend,
                device=(resolve_device(device) if execution == "vmap"
                        else device))
            dev, lanes = runtime.device, runtime.lanes
            items = _items_carry(inst, lanes, dev)
            # seed: root subproblem on worker 0
            runtime.push(0, {"layer": torch.zeros((1,), dtype=I32),
                             "state": torch.full((1,), inst.capacity,
                                                 dtype=I32),
                             "value": torch.zeros((1,), dtype=I32)}, 1)

        body = _make_worker_body(items["weights"][0], items["profits"][0],
                                 runtime.ops, lanes,
                                 explore_width=explore_width, batch=batch,
                                 n_vars=inst.n)
        carry = {"incumbent": torch.full((lanes.n_local,), NEG, dtype=I32,
                                         device=dev), **items}
        for key in ("explored", "ring_refused", "ring_peak"):
            carry[key] = torch.zeros((lanes.n_local,), dtype=I32, device=dev)
        carry = runtime.run(body, carry, max_rounds=max_supersteps,
                            fused=fused_rounds)

        with span("solve_end"):
            # (W, 3): explored, refused, peak of every lane, one read-back
            counts = lanes.all_gather(torch.stack(
                [carry["explored"], carry["ring_refused"],
                 carry["ring_peak"]], 1)).cpu()
            explored, refused, peak = counts.T.tolist()
            telemetry = runtime.telemetry
            stats = {
                "supersteps": runtime.rounds_run,
                "explored": int(sum(explored)),
                "transferred": telemetry.total_transferred,
                "per_worker_explored": [int(x) for x in explored],
                "telemetry": telemetry.summary(),
                "backend": runtime.ops.resolved,
                "execution": execution,
                "ring_refused_rows": int(sum(refused)),
                "per_worker_ring_peak": [int(x) for x in peak],
                # the post-push peak, or a post-splice size the host saw
                "ring_peak_rows": max(max(peak), max(
                    (r.sizes_max for r in telemetry.rounds), default=0)),
                "graph_captures": runtime.graph_blocks["captures"],
                "graph_replays": runtime.graph_blocks["replays"],
                "graph_eager_blocks": runtime.graph_blocks["eager"],
            }
            optimum = int(carry["incumbent"][0])
    if stats["ring_refused_rows"]:
        warnings.warn(
            f"parallel_solve: full rings of {capacity} rows refused "
            f"{stats['ring_refused_rows']} subproblems, so the optimum "
            f"{optimum} is not proven; raise capacity",
            RingOverflowWarning, stacklevel=2)
    return optimum, stats
