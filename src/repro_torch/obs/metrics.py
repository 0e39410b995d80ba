"""Metrics exposition: one registry, Prometheus text + JSON snapshot
(PyTorch port of ``repro.obs.metrics``, re-stated: it imports only
``typing``, so nothing here touches a device).

The runtime already measures everything a dashboard wants — per-round
steal counters and queue-depth statistics (:class:`~repro_torch.runtime.
telemetry.Telemetry`), detector lane states (:class:`~repro_torch.
runtime.detector.FailureDetector`), paging traffic (:class:`~repro_torch.
core.queue.PagedQueue`), admission loads (both masters) — but each behind
its own Python surface.  This module is the thin exposition layer: a
:class:`MetricsRegistry` of counters / gauges / histograms, a family of
``collect_*`` functions that read those objects and set the current
values, and two renderings of the same registry:

* :meth:`MetricsRegistry.to_prometheus` — the standard text exposition
  format (``# HELP`` / ``# TYPE`` / ``name{labels} value``), suitable for
  a node-exporter textfile collector or a scrape endpoint;
* :meth:`MetricsRegistry.snapshot` — a plain JSON-able dict.

Metric names, help strings, label keys and their order, bucket bounds and
the number format are the JAX module's, so a scraper reads the same text
from either package on the same run.  One gauge has no counterpart:
the JAX ``collect_runtime`` exports ``repro_compiled_programs``, the size
of its round jit cache; the port compiles no round program (a round is
issued from Python), so it does not export that gauge.

Collection is PULL-style and idempotent: calling a collector re-reads
the source object and overwrites the sample values, so a poller can call
``runtime_metrics(rt)`` (or ``cluster.metrics()`` /
``run_resilient(metrics_path=...)``'s periodic textfile writes) mid-run,
at any cadence, without perturbing the run — no instrumentation is
threaded into the dispatch path.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "collect_telemetry", "collect_detector", "collect_runtime",
           "collect_paged_queue", "collect_master", "runtime_metrics",
           "master_metrics", "write_textfile"]

LabelKey = Tuple[Tuple[str, str], ...]
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._samples: Dict[LabelKey, float] = {}

    def _set(self, value: float, labels: Dict[str, Any]) -> None:
        self._samples[_label_key(labels)] = float(value)

    def samples(self) -> Dict[LabelKey, float]:
        return dict(self._samples)

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.kind}"]

    def expose(self) -> List[str]:
        lines = self._header()
        for key, value in sorted(self._samples.items()):
            lines.append(f"{self.name}{_render_labels(key)} {value:g}")
        return lines

    def snapshot(self) -> Any:
        if list(self._samples) == [()]:
            return self._samples[()]
        return {_render_labels(k) or "{}": v
                for k, v in sorted(self._samples.items())}


class Counter(_Metric):
    """Monotone total.  ``inc`` accumulates; collectors reading an
    external monotone source (e.g. ``telemetry.total_steals``) overwrite
    the absolute value with ``set_total`` instead."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self._samples[key] = self._samples.get(key, 0.0) + float(n)

    def set_total(self, value: float, **labels) -> None:
        self._set(value, labels)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._set(value, labels)


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        counts = self._counts.setdefault(key, [0] * len(self.buckets))
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
        self._sum[key] = self._sum.get(key, 0.0) + float(value)
        self._n[key] = self._n.get(key, 0) + 1

    def expose(self) -> List[str]:
        lines = self._header()
        for key in sorted(self._counts):
            for b, c in zip(self.buckets, self._counts[key]):
                le = 'le="%g"' % b
                lines.append(f"{self.name}_bucket"
                             f"{_render_labels(key, le)} {c}")
            inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket{_render_labels(key, inf)} "
                         f"{self._n[key]}")
            lines.append(f"{self.name}_sum{_render_labels(key)} "
                         f"{self._sum[key]:g}")
            lines.append(f"{self.name}_count{_render_labels(key)} "
                         f"{self._n[key]}")
        return lines

    def snapshot(self) -> Any:
        out = {_render_labels(k): {
            "buckets": dict(zip((f"{b:g}" for b in self.buckets),
                                self._counts[k])),
            "sum": self._sum[k], "count": self._n[k]}
            for k in sorted(self._counts)}
        # Same collapsing rule as scalar metrics: one unlabeled series
        # reads as its value directly.
        if set(out) == {""}:
            return out[""]
        return out


class MetricsRegistry:
    """A named collection of metrics with idempotent get-or-create
    accessors (collectors re-run against the same registry update values
    in place rather than redefining metrics)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kwargs)
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __iter__(self) -> Iterable[_Metric]:
        return iter(self._metrics.values())

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics.values():
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        return {name: {"type": m.kind, "help": m.help,
                       "values": m.snapshot()}
                for name, m in sorted(self._metrics.items())}


def write_textfile(registry: MetricsRegistry, path: str) -> None:
    """Atomic textfile-collector write (tmp + rename, the node-exporter
    contract: a scraper never reads a half-written exposition)."""
    import os

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(registry.to_prometheus())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Collectors
# ---------------------------------------------------------------------------


def collect_telemetry(reg: MetricsRegistry, tele,
                      prefix: str = "repro") -> MetricsRegistry:
    """Read one :class:`~repro_torch.runtime.telemetry.Telemetry` stream
    into ``reg``: lifetime round totals, the adaptive trajectory
    endpoints, wave/request SLO aggregates, fault-event counters and — on
    probed runs — the per-phase time attribution."""
    s = tele.summary()
    reg.counter(f"{prefix}_rounds_total",
                "rebalancing rounds recorded").set_total(s["rounds"])
    reg.counter(f"{prefix}_steals_total",
                "victim->thief transfers planned").set_total(s["steals"])
    reg.counter(f"{prefix}_items_transferred_total",
                "queue items moved by steals").set_total(
                    s["items_transferred"])
    reg.counter(f"{prefix}_bytes_moved_total",
                "exchange payload bytes (busiest lane)").set_total(
                    s["bytes_moved"])
    reg.gauge(f"{prefix}_steal_proportion",
              "current adaptive steal proportion").set(s["proportion_final"])
    reg.gauge(f"{prefix}_imbalance",
              "max/mean queue depth after the last round").set(
                  s["imbalance_final"])
    reg.counter(f"{prefix}_straggler_steps_total",
                "straggler boost steps applied").set_total(
                    s["straggler_steps"])
    faults = reg.counter(f"{prefix}_fault_events_total",
                         "resilience events by kind")
    for kind, n in tele.fault_events.items():
        faults.set_total(n, kind=kind)
    if tele.waves:
        reg.counter(f"{prefix}_waves_total",
                    "workload waves recorded").set_total(s["waves"])
        reg.counter(f"{prefix}_served_total",
                    "requests completed").set_total(s["served"])
        reg.counter(f"{prefix}_tokens_total",
                    "tokens generated").set_total(s["tokens"])
    if tele.requests:
        slo = reg.gauge(f"{prefix}_request_rounds",
                        "request SLO percentiles, in logical rounds")
        for metric in ("ttft", "latency"):
            for pct in ("p50", "p95", "p99"):
                slo.set(s[f"{metric}_{pct}"], metric=metric, quantile=pct)
        lat = reg.histogram(f"{prefix}_request_latency_rounds",
                            "admit->finish latency per request, in rounds")
        for r in tele.requests:
            lat.observe(r.latency)
    ps = tele.phase_summary()
    if ps["timed_rounds"]:
        reg.counter(f"{prefix}_phase_timed_rounds_total",
                    "rounds with phase attribution").set_total(
                        ps["timed_rounds"])
        reg.counter(f"{prefix}_phase_estimated_rounds_total",
                    "attributed rounds using calibrated estimates"
                    ).set_total(ps["estimated_rounds"])
        sec = reg.counter(f"{prefix}_phase_seconds_total",
                          "attributed wall seconds by round phase")
        frac = reg.gauge(f"{prefix}_phase_fraction",
                         "share of attributed wall by round phase")
        for name, agg in ps["phases"].items():
            sec.set_total(agg["total_s"], phase=name)
            frac.set(agg["fraction"], phase=name)
    return reg


def collect_detector(reg: MetricsRegistry, detector,
                     prefix: str = "repro") -> MetricsRegistry:
    """Lane-state census of one :class:`~repro_torch.runtime.detector.
    FailureDetector` (healthy / suspected / dead counts plus the maximum
    live slow streak)."""
    states = detector.states()
    g = reg.gauge(f"{prefix}_detector_lanes",
                  "lanes per failure-detector state")
    for state in ("healthy", "suspected", "dead"):
        g.set(sum(1 for s in states if s == state), state=state)
    live_streaks = [detector.streak(w) for w in range(detector.n_lanes)
                    if states[w] != "dead"]
    reg.gauge(f"{prefix}_detector_max_slow_streak",
              "longest current consecutive-slow streak (live lanes)").set(
                  max(live_streaks) if live_streaks else 0)
    return reg


def collect_runtime(reg: MetricsRegistry, rt,
                    prefix: str = "repro") -> MetricsRegistry:
    """Poll one :class:`~repro_torch.runtime.executor.StealRuntime` (or the
    mesh subclass): queue depths and dead lanes, then its telemetry
    stream and attached detector.  No ``{prefix}_compiled_programs``
    gauge: the port has no round jit cache to count."""
    sizes = rt.sizes()
    reg.gauge(f"{prefix}_queue_items",
              "live items across all lanes").set(int(sizes.sum()))
    reg.gauge(f"{prefix}_queue_items_max",
              "deepest lane").set(int(sizes.max()) if sizes.size else 0)
    reg.gauge(f"{prefix}_lanes", "queue lanes").set(rt.n_workers)
    reg.gauge(f"{prefix}_dead_lanes",
              "lanes currently dead in the fault schedule").set(
                  int(rt.dead_lanes().sum()))
    collect_telemetry(reg, rt.telemetry, prefix)
    if rt.detector is not None:
        collect_detector(reg, rt.detector, prefix)
    return reg


def collect_paged_queue(reg: MetricsRegistry, pq,
                        prefix: str = "repro_paged") -> MetricsRegistry:
    """Paging traffic of one :class:`~repro_torch.core.queue.PagedQueue`:
    ring occupancy, host pages, and the spill/refill counters both
    ways."""
    reg.gauge(f"{prefix}_ring_items", "items in the device ring").set(
        int(pq.state.size))
    reg.gauge(f"{prefix}_host_pages", "overflow pages on host").set(
        len(pq.pages))
    reg.gauge(f"{prefix}_total_items",
              "ring + paged items").set(pq.total_size())
    reg.counter(f"{prefix}_spills_total",
                "host pages written").set_total(pq.spills)
    reg.counter(f"{prefix}_spilled_items_total",
                "items spilled to host").set_total(pq.spilled_items)
    reg.counter(f"{prefix}_refills_total",
                "host pages spliced back").set_total(pq.refills)
    reg.counter(f"{prefix}_refilled_items_total",
                "items refilled from host").set_total(pq.refilled_items)
    return reg


def collect_master(reg: MetricsRegistry, master,
                   prefix: str = "repro_serve") -> MetricsRegistry:
    """Admission-side view of either master (the host
    :class:`~repro_torch.serve.scheduler.AdmissionMaster` or the device
    :class:`~repro_torch.distributed.serve.RuntimeAdmissionMaster` — both
    expose the same ``replicas``/``stolen``/``proportion`` surface):
    per-replica load, eviction census, steal totals, plus the master's
    telemetry stream and detector when attached."""
    load = reg.gauge(f"{prefix}_replica_load",
                     "queued + in-flight requests per replica")
    queued = reg.gauge(f"{prefix}_replica_queued",
                       "queued requests per replica")
    completed = reg.counter(f"{prefix}_replica_completed_total",
                            "requests completed per replica")
    for r in master.replicas:
        rid = r.replica_id
        load.set(r.load(), replica=rid)
        queued.set(len(r.q), replica=rid)
        completed.set_total(r.completed, replica=rid)
    reg.gauge(f"{prefix}_evicted_replicas",
              "replicas currently evicted").set(
                  sum(1 for r in master.replicas if r.evicted))
    reg.counter(f"{prefix}_stolen_total",
                "requests moved by admission steals").set_total(
                    master.stolen)
    reg.gauge(f"{prefix}_proportion",
              "admission steal proportion").set(master.proportion)
    collect_telemetry(reg, master.telemetry, prefix)
    if getattr(master, "detector", None) is not None:
        collect_detector(reg, master.detector, prefix)
    return reg


# -- convenience entry points ------------------------------------------------


def runtime_metrics(rt, registry: Optional[MetricsRegistry] = None
                    ) -> MetricsRegistry:
    """One-call poll of a runtime: a fresh (or given) registry with
    :func:`collect_runtime` applied."""
    return collect_runtime(registry or MetricsRegistry(), rt)


def master_metrics(master, registry: Optional[MetricsRegistry] = None
                   ) -> MetricsRegistry:
    """One-call poll of an admission master (host or device)."""
    return collect_master(registry or MetricsRegistry(), master)
