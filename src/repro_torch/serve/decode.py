"""Continuous-batching decode: real model execution as a steal workload
(port of ``repro.serve.decode``).

A decode-step state machine runs INSIDE the executor round, as the worker
body of :meth:`repro_torch.runtime.StealRuntime.round`, so one body
serves all three execution modes (host-mastered stacked lanes,
device-mastered stacked lanes, one lane per process on a mesh).

Each lane owns:

* a ring of QUEUED requests (full prompt payloads — KV-free prefill
  work, which the superstep's bulk steal moves freely between lanes);
* ``n_slots`` decode SLOTS — in-flight sequences, each holding its
  position, token budget and a page-table row into the lane's paged KV
  pool (:mod:`repro_torch.serve.paged_kv`);
* an OUTPUT ring of finished-request records the host harvests after
  every round.

One round = continuous batching in miniature: bulk-pop as many queued
requests as there are free slots (K3, one launch for all lanes), allocate
KV pages (slots stall under page pressure instead of erroring), advance
EVERY active slot by one token — prompt tokens are teacher-forced one at
a time, so prefill and decode are the same per-slot step and sequences at
different phases batch together — then retire finished sequences, pushing
their output record and freeing their pages in the SAME round their slot
reopens.  Then the superstep rebalances the queued requests (K1 window,
K4 splice).

The JAX package writes the body for one lane and maps it with
``jax.vmap``; here it is written once over the lanes the runtime holds
(``(n, S, ...)``: all W stacked, 1 on a mesh rank), and the model runs
one batched decode step over the ``n * S`` slots with per-row positions
(``DecoderLM.decode_step``).

Per-request greedy tokens depend only on (params, prompt, budget) — slot
assignment, stalls and steals change WHEN a token is produced, never its
value.  Timestamps (admit / first token / finish) are stamped in LOGICAL
rounds and flow into :class:`repro_torch.runtime.telemetry.Telemetry` as
request records.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._tree import resolve_device, tree_map
from repro_torch.core import ops as bulk_ops
from repro_torch.core.ops import to_numpy
from repro_torch.core.policy import StealPolicy, plan_transfers
from repro_torch.core.sharded_queue import make_sharded_queues
from repro_torch.runtime.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.serve import paged_kv
from repro_torch.serve.scheduler import Request
from repro_torch.train.fault import StragglerMonitor

Pytree = Any
I32 = torch.int32

__all__ = ["DecodePolicy", "DecodeCluster", "request_spec", "output_spec",
           "encode_requests", "init_decode_state", "make_decode_body"]

_NOOP_WATERMARK = 2 ** 30 - 1
# the per-slot fields a migration moves with the slot's pages
_SLOT_FIELDS = ("rid", "plen", "maxn", "admit", "first", "cur", "pos",
                "prompt", "toks", "n_alloc")


@dataclasses.dataclass(frozen=True)
class DecodePolicy:
    """Geometry + steal knobs of the decode subsystem (per lane).

    Attributes:
      n_slots: concurrent in-flight sequences per lane.
      max_prompt / max_new: static per-request bounds (ring item payload
        is ``max_prompt + 4`` int32s; the KV budget per sequence is
        ``max_prompt + max_new`` rows).
      page_size: KV rows per page.
      n_pages: physical pages per lane pool.  ``None`` sizes the pool so
        every slot can always complete (no page pressure); smaller
        values make page pressure a real scheduling signal.
      out_capacity: finished-record ring size (must cover retirements
        between host harvests; the cluster harvests every round).
      steal: ``"queue"`` (only KV-free queued prefill items ride the
        superstep exchange) or ``"migrate"`` (additionally, the master may
        move one in-flight request per round between lanes, pages and
        all, when token loads diverge past ``migrate_threshold``).
      migrate_threshold: max/min token-load ratio that triggers a
        migration under ``steal="migrate"``.
      load_low / load_high: token-load watermarks for the adaptive
        steal-proportion controller (``None`` derives them from one
        request's worth of tokens).
    """

    n_slots: int = 4
    max_prompt: int = 16
    max_new: int = 16
    page_size: int = 8
    n_pages: Optional[int] = None
    out_capacity: Optional[int] = None
    steal: str = "queue"
    migrate_threshold: float = 1.5
    load_low: Optional[int] = None
    load_high: Optional[int] = None

    def __post_init__(self):
        if self.steal not in ("queue", "migrate"):
            raise ValueError(f"steal must be 'queue' or 'migrate', got "
                             f"{self.steal!r}")

    @property
    def pages_per_seq(self) -> int:
        return paged_kv.pages_for(self.max_prompt + self.max_new,
                                  self.page_size)

    @property
    def pool_pages(self) -> int:
        return (self.n_pages if self.n_pages is not None
                else self.n_slots * self.pages_per_seq)

    @property
    def out_ring(self) -> int:
        return (self.out_capacity if self.out_capacity is not None
                else 4 * self.n_slots)

    @property
    def token_low(self) -> int:
        return (self.load_low if self.load_low is not None
                else self.max_prompt + self.max_new)

    @property
    def token_high(self) -> int:
        return (self.load_high if self.load_high is not None
                else 3 * (self.max_prompt + self.max_new))


def _i32(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=I32)


def request_spec(policy: DecodePolicy) -> Dict[str, torch.Tensor]:
    """Queue item: one admitted (prefill-pending, KV-free) request."""
    return {"rid": _i32(), "plen": _i32(), "max_new": _i32(),
            "admit": _i32(), "prompt": _i32(policy.max_prompt)}


def output_spec(policy: DecodePolicy) -> Dict[str, torch.Tensor]:
    """Output-ring item: one finished request's tokens + SLO stamps."""
    return {"rid": _i32(), "n": _i32(), "admit": _i32(), "first": _i32(),
            "finish": _i32(), "toks": _i32(policy.max_new)}


def encode_requests(requests: Sequence[Request], policy: DecodePolicy,
                    admit_round: int, *, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Pad a request batch into the queue-item layout (rows = len), on
    ``device`` (default CUDA; raises without it)."""
    n = len(requests)
    prompt = np.zeros((n, policy.max_prompt), np.int32)
    plen = np.zeros((n,), np.int32)
    maxn = np.zeros((n,), np.int32)
    rid = np.zeros((n,), np.int32)
    for i, r in enumerate(requests):
        p = list(r.prompt)
        if not 0 < len(p) <= policy.max_prompt:
            raise ValueError(
                f"request {r.rid}: prompt length {len(p)} outside "
                f"(0, {policy.max_prompt}]")
        if not 0 < r.max_new <= policy.max_new:
            raise ValueError(
                f"request {r.rid}: max_new {r.max_new} outside "
                f"(0, {policy.max_new}]")
        prompt[i, : len(p)] = p
        plen[i] = len(p)
        maxn[i] = r.max_new
        rid[i] = r.rid
    dev = resolve_device(device)
    return {"rid": torch.from_numpy(rid).to(dev),
            "plen": torch.from_numpy(plen).to(dev),
            "max_new": torch.from_numpy(maxn).to(dev),
            "admit": torch.full((n,), int(admit_round), dtype=I32,
                                device=dev),
            "prompt": torch.from_numpy(prompt).to(dev)}


# ---------------------------------------------------------------------------
# Per-lane decode state
# ---------------------------------------------------------------------------


def init_decode_state(model, policy: DecodePolicy, n_lanes: int, *,
                      device=None) -> Pytree:
    """The stacked ``(n_lanes, ...)`` decode carry — slot arrays, the paged
    KV pool and the finished-record output ring, per lane — on ``device``
    (default CUDA; raises without it)."""
    dev = resolve_device(device)
    S, MP, MN = policy.n_slots, policy.max_prompt, policy.max_new
    pool = paged_kv.make_pool(model, n_slots=S, n_pages=policy.pool_pages,
                              page_size=policy.page_size,
                              pages_per_seq=policy.pages_per_seq,
                              device=dev)

    def z(*s):
        return torch.zeros((n_lanes,) + s, dtype=I32, device=dev)

    def tile(x):
        return x[None].repeat((n_lanes,) + (1,) * x.ndim)

    return {
        "pages": tree_map(tile, pool["pages"]),
        "table": tile(pool["table"]), "owner": tile(pool["owner"]),
        "n_alloc": z(S),
        "active": torch.zeros((n_lanes, S), dtype=torch.bool, device=dev),
        "pos": z(S), "plen": z(S), "maxn": z(S),
        "rid": torch.full((n_lanes, S), -1, dtype=I32, device=dev),
        "admit": z(S),
        "first": torch.full((n_lanes, S), -1, dtype=I32, device=dev),
        "cur": z(S), "prompt": z(S, MP), "toks": z(S, MN),
        "round": z(), "stalls": z(), "dropped": z(), "load": z(),
        "out_q": make_sharded_queues(n_lanes, policy.out_ring,
                                     output_spec(policy), device=dev),
    }


def _sum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum over the slot axis."""
    return x.to(I32).sum(-1, dtype=I32)


def make_decode_body(model, params, policy: DecodePolicy,
                     ops_in: bulk_ops.BulkOps, ops_out: bulk_ops.BulkOps):
    """The decode worker body ``(qs, state) -> (qs, state)`` over the lanes
    a runtime holds (leaves ``(n, ...)``).

    Device tensors only, no host read: the admission count, the page
    grants and the retirements stay on the device; the rebalancing
    superstep that follows it inside the round holds the lane
    collectives.
    """
    S, MP, MN, PS = (policy.n_slots, policy.max_prompt, policy.max_new,
                     policy.page_size)
    n_pages = policy.pool_pages
    PP = policy.pages_per_seq

    def body(q, st):
        st = dict(st)
        r = st["round"]                                  # (n,)
        n = r.shape[0]
        dev = r.device
        slots = torch.arange(S, dtype=I32, device=dev)
        active = st["active"]                            # (n, S)
        # -- continuous admission: bulk-pop one request per free slot,
        # bounded by the page RESERVATION budget.  Every active slot holds
        # a reservation for its full sequence (pages_for(plen + max_new));
        # a request is only seated while the pool can still cover a
        # worst-case newcomer, so allocation failure is transient and page
        # pressure back-pressures ADMISSION instead of deadlocking seated
        # sequences.
        n_free = _sum(~active)
        pf = (st["plen"] + st["maxn"] + PS - 1) // PS
        committed = _sum(torch.where(active, pf, 0))
        budget = torch.clamp(n_pages - committed, min=0) // PP
        n_admit = torch.minimum(n_free, budget)
        blocked = torch.clamp(torch.minimum(n_free, q.size) - n_admit, min=0)
        q, batch, n_pop = ops_in.pop_bulk(q, S, n_admit)
        # free slots first; stable, as jnp.argsort(active) is
        order = torch.argsort(active.to(I32), dim=-1, stable=True).long()
        take = slots[None, :] < n_pop[:, None]

        def seat(cur, new):
            extra = (1,) * (cur.ndim - 2)
            idx = order.reshape(order.shape + extra).expand_as(cur)
            vals = torch.where(take.reshape(take.shape + extra),
                               new.to(cur.dtype), cur.gather(1, idx))
            return cur.scatter(1, idx, vals)

        zero = torch.zeros((n, S), dtype=I32, device=dev)
        st["rid"] = seat(st["rid"], batch["rid"])
        st["plen"] = seat(st["plen"], batch["plen"])
        st["maxn"] = seat(st["maxn"], batch["max_new"])
        st["admit"] = seat(st["admit"], batch["admit"])
        st["prompt"] = seat(st["prompt"], batch["prompt"])
        st["pos"] = seat(st["pos"], zero)
        st["cur"] = seat(st["cur"], zero)
        st["first"] = seat(st["first"], zero - 1)
        st["toks"] = seat(st["toks"], torch.zeros_like(st["toks"]))
        active = seat(active, torch.ones_like(active))
        st["active"] = active

        # -- page allocation; slots stall under page pressure ------------
        pos = st["pos"]
        need = active & (pos // PS >= st["n_alloc"])
        table, owner, n_alloc = paged_kv.alloc_pages(
            st["table"], st["owner"], st["n_alloc"], need, pos // PS)
        advance = active & (pos // PS < n_alloc)
        # Stalls = free slots the page budget refused to fill while
        # requests were queued + seated slots whose page grant was
        # deferred a round (transient only, by the reservation invariant).
        st["stalls"] = st["stalls"] + blocked + _sum(active & ~advance)

        # -- one decode step for every slot (prompt teacher-forced) ------
        cache = paged_kv.gather_slot_caches(st["pages"], table, pos)
        pp = st["prompt"].gather(2, pos.clamp(0, MP - 1).long()[..., None])
        feed = torch.where(pos < st["plen"], pp[..., 0], st["cur"])
        # decode_step writes every row's K / V at min(pos, C - 1); a slot
        # that does not advance keeps its cache, so the written rows are
        # kept for the write-back to restore
        kept = paged_kv.written_rows(cache)
        logits, cache = model.decode_step(params, cache,
                                          feed.reshape(n * S, 1))
        nxt = logits[:, 0, :].argmax(-1).to(I32).reshape(n, S)

        gidx = pos + 1 - st["plen"]                      # generated index
        valid_gen = advance & (gidx >= 0) & (gidx < MN)
        # the JAX package's toks.at[row, gidx].set(nxt, mode="drop"): one
        # column per valid slot, nothing elsewhere
        hit = valid_gen[..., None] & (
            torch.arange(MN, device=dev) == gidx[..., None])
        st["toks"] = torch.where(hit, nxt[..., None], st["toks"])
        st["first"] = torch.where(advance & (gidx == 0), r[:, None],
                                  st["first"])
        st["cur"] = torch.where(advance, nxt, st["cur"])
        pos = pos + advance.to(I32)
        st["pos"] = pos
        st["pages"] = paged_kv.scatter_slot_caches(
            st["pages"], table, cache, kept, advance)

        # -- retire finished sequences; free pages the same round --------
        fin = active & (pos - st["plen"] >= st["maxn"])
        n_fin = _sum(fin)
        # finished slots first; stable, as jnp.argsort(~fin) is
        ordf = torch.argsort((~fin).to(I32), dim=-1, stable=True)
        rec = {"rid": st["rid"].gather(1, ordf),
               "n": st["maxn"].gather(1, ordf),
               "admit": st["admit"].gather(1, ordf),
               "first": st["first"].gather(1, ordf),
               "finish": r[:, None].expand(n, S).contiguous(),
               "toks": st["toks"].gather(
                   1, ordf[..., None].expand(n, S, MN))}
        out_q, pushed = ops_out.push(st["out_q"], rec, n_fin, donate=True)
        st["out_q"] = out_q
        st["dropped"] = st["dropped"] + (n_fin - pushed)
        table, owner, n_alloc = paged_kv.free_pages(table, owner, n_alloc,
                                                    fin)
        st["table"], st["owner"], st["n_alloc"] = table, owner, n_alloc
        active = active & ~fin
        st["active"] = active

        # -- true token load: queued work + in-flight remainder ----------
        cap = q.buf["plen"].shape[1]
        offs = torch.arange(cap, dtype=I32, device=dev)
        live = ((offs[None, :] - q.lo[:, None]) % cap) < q.size[:, None]
        queued = _sum(torch.where(live, q.buf["plen"] + q.buf["max_new"], 0))
        inflight = _sum(torch.where(active, st["plen"] + st["maxn"] - pos,
                                    0))
        st["load"] = queued + inflight
        st["round"] = r + 1
        return q, st

    return body


# ---------------------------------------------------------------------------
# The decode cluster
# ---------------------------------------------------------------------------


class DecodeCluster:
    """N decode lanes + one admission master, in any execution mode.

    ``execution`` selects where the MASTER lives (the decode body is the
    same everywhere):

    * ``"host"`` — the rebalancing plan runs on the host between rounds
      (``plan_transfers`` on queue sizes, owner-side ``steal_exact`` +
      bulk push per pair); the in-round superstep is a no-op;
    * ``"vmap"`` / ``"mesh"`` — every round IS a device superstep via
      :class:`repro_torch.distributed.RuntimeAdmissionMaster`: decode
      body, then plan + compact exchange (one lane per process under
      ``"mesh"``).

    ``balance=False`` freezes rebalancing entirely (the static baseline);
    ``admission`` picks least token-load (``"load"``) or static
    round-robin (``"rr"``) routing.  The steal proportion is servoed by an
    :class:`~repro_torch.runtime.adaptive.AdaptiveController` fed TRUE
    per-lane token loads (queued + in-flight tokens, computed on the
    device) rather than request counts.

    ``device`` places the stacked lanes (default CUDA; raises without
    it); ``params`` must live there.  Under ``"mesh"`` every rank of the
    mesh builds the cluster and calls ``submit`` / ``step`` /
    ``run_until_drained`` / ``stats`` with the same arguments in the same
    order, with ``params`` on its own lane's device: routing, the served
    records, the telemetry and ``stats()`` are the stacked run's on every
    rank.
    """

    def __init__(self, model, params, *,
                 policy: Optional[DecodePolicy] = None,
                 steal_policy: Optional[StealPolicy] = None,
                 n_lanes: int = 4, capacity: int = 64,
                 execution: str = "vmap",
                 balance: bool = True, admission: str = "load",
                 adaptive: bool = True,
                 adaptive_config: Optional[AdaptiveConfig] = None,
                 mesh=None, backend=None,
                 straggler_threshold: float = 2.0,
                 device=None):
        if execution not in ("host", "vmap", "mesh"):
            raise ValueError(f"unknown execution {execution!r}")
        if admission not in ("load", "rr"):
            raise ValueError(f"unknown admission {admission!r}")
        self.model, self.params = model, params
        self.policy = policy or DecodePolicy()
        self.execution = execution
        self.balance = bool(balance)
        self.admission = admission
        self.n_lanes = int(n_lanes)
        # Decode-tuned defaults: queued backlogs are small (slots absorb
        # one request per free seat per round), so even a 2-deep queue
        # next to an idle lane is worth moving.
        spol = steal_policy or StealPolicy(
            proportion=0.5, low_watermark=0, high_watermark=2,
            queue_limit=1, max_steal=min(64, capacity))
        self._steal_policy = spol
        noop = dataclasses.replace(spol, high_watermark=_NOOP_WATERMARK,
                                   queue_limit=_NOOP_WATERMARK)
        # The in-round superstep rebalances only in device-mastered,
        # balanced mode; host mode (and the static baseline) runs the
        # no-victim plan, which moves nothing.
        trace_pol = spol if (balance and execution != "host") else noop
        spec = request_spec(self.policy)
        self.master = None
        if execution == "host":
            from repro_torch.runtime.executor import StealRuntime

            self.runtime = StealRuntime(
                self.n_lanes, capacity, spec, policy=trace_pol,
                adaptive=False, backend=backend, device=device)
        else:
            from repro_torch.distributed.serve import RuntimeAdmissionMaster

            self.master = RuntimeAdmissionMaster(
                self.n_lanes, policy=trace_pol, adaptive=False,
                execution=execution, capacity=capacity, mesh=mesh,
                item_spec=spec, elastic=False, backend=backend, device=device)
            self.runtime = self.master.runtime
        self.device = self.runtime.device
        # Token-load-watermarked proportion servo: its output is handed to
        # the round as the proportion each step.
        token_pol = dataclasses.replace(
            spol, low_watermark=self.policy.token_low,
            high_watermark=self.policy.token_high)
        self.controller = (AdaptiveController(token_pol, adaptive_config)
                           if (adaptive and self.balance) else None)
        self._ops_out = bulk_ops.make_ops("reference", check=False)
        self._worker = make_decode_body(model, params, self.policy,
                                        self.runtime.ops, self._ops_out)
        self.carry = init_decode_state(model, self.policy,
                                       self.runtime.lanes.n_local,
                                       device=self.device)
        self._requests: Dict[int, Request] = {}
        self.done: List[Request] = []
        self.pending = 0
        self.rounds = 0
        self.stolen = 0
        self.migrated = 0
        self._loads = np.zeros((self.n_lanes,), np.int64)
        self._rr = 0
        self.monitor = StragglerMonitor(threshold=straggler_threshold)

    # -- surface -------------------------------------------------------------

    @property
    def telemetry(self):
        return self.runtime.telemetry

    @property
    def lanes(self):
        return self.runtime.lanes

    def note_straggler(self, rounds: int = 4, factor: float = 1.5) -> None:
        """Straggler response: counted in telemetry and, when the token
        controller is on, a temporary steal-proportion boost."""
        self.telemetry.record_fault("straggler")
        if self.controller is not None:
            self.controller.flag_straggler(rounds=rounds, factor=factor)

    def _row(self, lane: int) -> Optional[int]:
        """Lane ``lane``'s row in this process's carry, or None."""
        lanes = self.lanes
        return lane - lanes.offset if lanes.owns(lane) else None

    # -- admission -----------------------------------------------------------

    def submit(self, requests: Sequence[Request]) -> None:
        """Admit a request batch: ``admission="load"`` routes each
        request greedily to the currently least token-loaded lane
        (updating the estimate as it assigns, so a burst spreads by COST);
        ``admission="rr"`` spreads by COUNT (the static baseline).  Either
        way, one bulk ring push (K2) per target lane.  On a mesh every
        rank routes the same way and the lane's owner pushes; the pushed
        counts are gathered, so an overflow raises on every rank."""
        requests = list(requests)
        if not requests:
            return
        for r in requests:
            self._requests[r.rid] = r
        groups: Dict[int, List[Request]] = {}
        if self.admission == "load":
            est = self._loads.copy()
            for r in requests:
                lane = int(np.argmin(est))
                est[lane] += len(r.prompt) + r.max_new
                groups.setdefault(lane, []).append(r)
        else:
            for r in requests:
                lane = self._rr % self.n_lanes
                self._rr += 1
                groups.setdefault(lane, []).append(r)
        pushed = np.zeros((self.n_lanes,), np.int64)
        for lane, reqs in groups.items():
            if self.lanes.owns(lane):
                batch = encode_requests(reqs, self.policy, self.rounds,
                                        device=self.device)
                pushed[lane] = self.runtime.push(lane, batch, len(reqs))
        if not self.lanes.stacked:
            mine = torch.tensor([pushed[self.lanes.offset]], dtype=I32,
                                device=self.device)
            pushed = self.lanes.all_gather(mine).cpu().numpy()
        for lane, reqs in groups.items():
            if pushed[lane] < len(reqs):
                raise RuntimeError(
                    f"admission ring overflow on lane {lane}: pushed "
                    f"{int(pushed[lane])}/{len(reqs)} (capacity "
                    f"{self.runtime.capacity})")
            self._loads[lane] += sum(
                len(r.prompt) + r.max_new for r in reqs)
        self.pending += len(requests)

    # -- host-mastered rebalancing -------------------------------------------

    def _host_rebalance(self) -> int:
        """One host-master round over the device rings: the same
        ``plan_transfers`` pairing the superstep runs, applied by the host
        via owner-side exact steals (K1) + bulk pushes (K2)."""
        pol = self._steal_policy
        if self.controller is not None:
            pol = dataclasses.replace(
                pol, proportion=self.controller.effective_proportion)
        rt = self.runtime
        sizes = torch.as_tensor(rt.sizes(), dtype=I32)
        plan = plan_transfers(sizes, pol).numpy()
        moved = 0
        for thief in range(self.n_lanes):
            src, n = int(plan[thief, 0]), int(plan[thief, 1])
            if n <= 0 or src == thief:
                continue
            batch, got = rt.steal_exact(src, n, pol.max_steal)
            moved += rt.push(thief, batch, got)
        self.stolen += moved
        return moved

    # -- in-flight migration (steal="migrate") -------------------------------

    def _maybe_migrate(self, loads: np.ndarray) -> int:
        """Move ONE in-flight request — slot state, KV pages and all —
        from the most to the least token-loaded lane when their loads
        diverge past ``migrate_threshold``.  Host-side surgery on the
        carry at a round boundary (the only consistency point); page
        content moves bitwise, so the request's remaining tokens are
        unchanged by the move.  On a mesh every rank takes the decision
        from gathered slot state, and the donor's slot row and pages reach
        the target in one broadcast from the donor."""
        c = self.carry
        d, t_lane = int(np.argmax(loads)), int(np.argmin(loads))
        if d == t_lane:
            return 0
        if loads[d] <= self.policy.migrate_threshold * max(loads[t_lane], 1):
            return 0
        small = tree_map(to_numpy, self.lanes.all_gather_tree(
            {k: c[k] for k in ("active", "plen", "maxn", "pos", "n_alloc",
                               "owner", "table")}))
        active, plen, maxn, pos = (small[k] for k in ("active", "plen",
                                                      "maxn", "pos"))
        donor_slots = np.where(active[d])[0]
        free_slots = np.where(~active[t_lane])[0]
        if donor_slots.size == 0 or free_slots.size == 0:
            return 0
        remaining = (plen[d] + maxn[d] - pos[d])[donor_slots]
        s = int(donor_slots[int(np.argmax(remaining))])
        t = int(free_slots[0])
        n_al = int(small["n_alloc"][d, s])
        free_pages = np.where(small["owner"][t_lane] < 0)[0]
        # Preserve the destination's reservation invariant: the moved
        # sequence's FULL page demand must fit next to the active
        # reservations already there, or admission could deadlock.
        PS = self.policy.page_size
        pf = -(-(plen[t_lane] + maxn[t_lane]) // PS)
        committed = int(pf[active[t_lane]].sum())
        seq_pf = -(-(int(plen[d, s]) + int(maxn[d, s])) // PS)
        if committed + seq_pf > self.policy.pool_pages:
            return 0
        if free_pages.size < n_al:
            return 0
        src_pages = torch.as_tensor(small["table"][d, s, :n_al]).long()
        dst_pages = torch.as_tensor(free_pages[:n_al]).long()
        rd, rt_ = self._row(d), self._row(t_lane)
        # the donor's slot row and pages; a same-shaped stand-in elsewhere
        at, slot = (rd, s) if rd is not None else (0, 0)
        packet = {"slot": {k: c[k][at, slot] for k in _SLOT_FIELDS},
                  "pages": tree_map(lambda x: x[at, src_pages.to(x.device)],
                                    c["pages"])}
        packet = self.lanes.broadcast_tree(packet, d)
        if rt_ is not None:
            for k in _SLOT_FIELDS:
                c[k][rt_, t] = packet["slot"][k]
            dst = dst_pages.to(self.device)
            tree_map(lambda x, p: x[rt_].index_copy_(0, dst, p),
                     c["pages"], packet["pages"])
            c["active"][rt_, t] = True
            c["table"][rt_, t, :n_al] = dst.to(I32)
            c["owner"][rt_, dst] = t
        if rd is not None:
            c["active"][rd, s] = False
            c["owner"][rd, src_pages.to(self.device)] = -1
            c["table"][rd, s] = self.policy.pool_pages    # the trash page
            c["n_alloc"][rd, s] = 0
        self.migrated += 1
        return 1

    # -- the round -----------------------------------------------------------

    def _harvest(self) -> List[Dict[str, np.ndarray]]:
        """Pop every finished-request record off each lane's output ring
        (one bulk pop over the lanes held here; on a mesh one gather of
        the records, padded to the ring) and clear the rings in the
        carry.  Records come lane-major, as the JAX package's are."""
        c = self.carry
        out_q, batch, n = self._ops_out.pop_bulk(c["out_q"],
                                                 self.policy.out_ring,
                                                 c["out_q"].size)
        c["out_q"] = out_q
        got = tree_map(to_numpy, self.lanes.all_gather_tree(
            {"batch": batch, "n": n}))
        return [tree_map(lambda x, i=i, j=j: x[i, j], got["batch"])
                for i in range(self.n_lanes) for j in range(int(got["n"][i]))]

    def step(self) -> int:
        """One serving tick = one executor round (decode body + exchange
        superstep), then host harvest, SLO accounting, optional
        migration, and the token-load controller update."""
        self.monitor.start()
        if self.controller is not None:
            self.runtime.policy = dataclasses.replace(
                self.runtime.policy,
                proportion=self.controller.effective_proportion)
        before = self.telemetry.total_transferred
        self.carry, _stats = self.runtime.round(self._worker, self.carry)
        self.stolen += self.telemetry.total_transferred - before
        if self.execution == "host" and self.balance:
            self._host_rebalance()
        records = self._harvest()
        slow = self.monitor.observe()
        # one read of every lane's load, overflow count and straggler flag
        # (a gather on a mesh, so every rank decides alike)
        c = self.carry
        flags = torch.full_like(c["load"], int(slow))
        lane_ints = to_numpy(self.lanes.all_gather(
            torch.stack([c["load"], c["dropped"], flags], dim=-1)))
        if int(lane_ints[:, 1].sum()):
            raise RuntimeError(
                "output ring overflow: finished records were dropped — "
                "raise DecodePolicy.out_capacity")
        served, tokens = 0, 0
        for rec in records:
            n = int(rec["n"])
            self.telemetry.record_request(
                rid=int(rec["rid"]), admit=int(rec["admit"]),
                first=int(rec["first"]), finish=int(rec["finish"]),
                tokens=n)
            req = self._requests.get(int(rec["rid"]))
            if req is not None:
                req.output = [int(x) for x in rec["toks"][:n]]
                self.done.append(req)
            served += 1
            tokens += n
        self.pending -= served
        loads = lane_ints[:, 0].astype(np.int64)
        migrated = 0
        if self.balance and self.policy.steal == "migrate":
            migrated = self._maybe_migrate(loads)
        self._loads = loads
        stragglers = 0
        if lane_ints[:, 2].any():
            stragglers = 1
            self.note_straggler()
        if self.controller is not None:
            self.controller.update(self._loads)
        self.telemetry.record_wave(
            loads=self._loads, served=served, tokens=tokens,
            stragglers=stragglers, migrated=migrated)
        self.rounds += 1
        return served

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.pending <= 0:
                break
            self.step()
        return self.done

    def stats(self) -> Dict:
        c = self.carry
        small = tree_map(to_numpy, self.lanes.all_gather_tree(
            {"owner": c["owner"], "stalls": c["stalls"]}))
        one_page = tree_map(lambda x: x[0], c["pages"])
        return {
            "execution": self.execution,
            "balance": self.balance,
            "admission": self.admission,
            "steal": self.policy.steal,
            "loads": [int(x) for x in self._loads],
            "queued": [int(x) for x in self.runtime.sizes()],
            "pending": self.pending,
            "served": len(self.done),
            "stolen": self.stolen,
            "migrated": self.migrated,
            "stalls": int(small["stalls"].sum()),
            "kv_tokens": [
                paged_kv.pool_token_count(one_page, small["owner"][i],
                                          self.policy.page_size)
                for i in range(self.n_lanes)],
            "proportion": (self.controller.effective_proportion
                           if self.controller else
                           self.runtime.policy.proportion),
            "backend": self.runtime.ops.resolved,
            "telemetry": self.telemetry.summary(),
        }
