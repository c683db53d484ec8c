"""Serving telemetry: the span tracer with its flight-recorder ring and
Perfetto export, the metrics registry and its OpenMetrics text, the SLO
monitor, the compile ledger of the serving programs and the bounded
sample of the engine's ITL stream. Counterpart:
``paddle_tpu/utils/telemetry.py``, whose host code this module carries
over unchanged; only ``CompileWatch`` differs (below).

- ``Tracer``: per-request spans (queued, prefill, splice wait, decode,
  each closed at a life's transition; one async "request" span per
  request, kept across preemption and across replicas by its trace id)
  and per-step events, in a bounded ring (``dropped`` counts what fell
  off), exported as Chrome-trace / Perfetto JSON. Engine records land
  on ``pid = replica_id``, fleet records on ``FLEET_PID``.
- ``MetricsRegistry``: counters, gauges and fixed-bucket histograms;
  ``publish`` mirrors a ``stats()`` dict (ints become counters, floats
  gauges); ``openmetrics_text`` formats a snapshot.
- ``SLOPolicy`` / ``SLOMonitor``: per-class TTFT / ITL targets over
  sliding windows with burn rates and headroom.
- ``Reservoir``: seeded Algorithm-R sampling, and ``merge`` of several
  reservoirs in proportion to their streams.
- ``CompileWatch``: in JAX a serving program compiles the first time a
  shape reaches it, and the watch reads that off the jit cache. In the
  port a program is one CUDA graph per static key
  (``inference/programs.py``), so a "compile" is the first capture of a
  key on the card, or the first eager run of a key on the CPU; the
  watch is told the key. ``seal()`` declares the set complete: a key
  first seen after it counts as an unexpected recompile. Bound to a
  tracer, its compile spans and ``compile.*`` counters land in the
  tracer's registry, as in JAX.

``tracer=None`` (the default everywhere) is a bitwise no-op: every hook
sits behind an ``if tracer is not None`` guard, no key is drawn, no
device call is made and no schedule changes.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Tracer", "MetricsRegistry", "Reservoir", "CompileWatch",
           "SLOPolicy", "SLOMonitor", "FLEET_PID",
           "DEFAULT_TIME_BUCKETS_S", "openmetrics_text"]

# the track fleet-level records render on (routing, breaker, migration,
# the request async spans); engine records use pid = replica_id
FLEET_PID = 1000

# fixed histogram buckets for second-valued observations (ITL, TTFT,
# latency, span durations): roughly log-spaced 0.5 ms .. 60 s
DEFAULT_TIME_BUCKETS_S = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5,
    1.0, 2.0, 5.0, 10.0, 30.0, 60.0)


class Reservoir:
    """Seeded Algorithm-R reservoir: a bounded uniform sample of an
    unbounded stream. Exact (every sample retained, in order) while the
    stream is <= k items; beyond that each seen item has equal
    probability k/n of being retained, so quantiles stay within
    sampling tolerance while memory is O(k). Deterministic: the same
    seed + the same stream reproduces the same sample (the RNG is
    private — engine PRNG streams are untouched)."""

    def __init__(self, k: int = 4096, seed: int = 0):
        self.k = int(k)
        self._rng = np.random.RandomState(seed)
        self.samples: List[float] = []
        self.n = 0                      # items seen (>= len(samples))

    def append(self, x: float):
        if self.n < self.k:
            self.samples.append(float(x))
        else:
            j = int(self._rng.randint(0, self.n + 1))
            if j < self.k:
                self.samples[j] = float(x)
        self.n += 1

    def extend(self, xs: Sequence[float]):
        for x in xs:
            self.append(x)

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)

    @staticmethod
    def merge(parts, k: int = 4096, seed: int = 0) -> List[float]:
        """Combine several (samples, n_seen) parts — Reservoir objects
        or (list, n) tuples — into ONE bounded sample whose composition
        is proportional to each part's true stream size (concatenating
        raw reservoirs would over-weight small streams). Exact
        concatenation when everything fits in k."""
        norm = []
        for p in parts:
            if isinstance(p, Reservoir):
                norm.append((p.samples, p.n))
            else:
                s, n = p
                norm.append((list(s), int(n)))
        norm = [(s, n) for s, n in norm if s]
        total = sum(n for _, n in norm)
        if total <= k:
            return [x for s, _ in norm for x in s]
        rng = np.random.RandomState(seed)
        out: List[float] = []
        for s, n in norm:
            want = max(1, int(round(k * n / total)))
            if want >= len(s):
                out.extend(s)
            else:
                idx = rng.choice(len(s), size=want, replace=False)
                out.extend(s[i] for i in idx)
        return out


class _Histogram:
    """Fixed-bucket histogram: counts[i] = observations <= buckets[i]
    boundary (last slot is the overflow), plus n/sum for means."""

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.n = 0
        self.sum = 0.0

    def observe(self, v: float, n: int = 1):
        self.counts[bisect_right(self.buckets, float(v))] += int(n)
        self.n += int(n)
        self.sum += float(v) * int(n)

    def snapshot(self) -> dict:
        return {"buckets": list(self.buckets),
                "counts": list(self.counts),
                "n": self.n, "sum": self.sum,
                "mean": (self.sum / self.n) if self.n else None}


class MetricsRegistry:
    """Unified counters/gauges/histograms across engine, fleet, cache
    and chaos. Two feeding paths:

    - live: ``inc(name)`` from the tracer's event/span hooks (event
      counts, span-duration histograms) — cheap dict ops;
    - published: ``publish(prefix, stats_dict)`` mirrors a subsystem's
      ``stats()`` dict under namespaced keys (ints -> counters, floats
      -> gauges; None/bool/nested values skipped), making the stats
      dicts views over the registry — ``registry.value("engine.X") ==
      engine.stats()["X"]`` for every numeric key (tested).

    Thread-safety: all dict membership mutations and ``snapshot()``
    take one lock, so a watchdog-thread export can never hit a
    dictionary-changed-during-iteration crash while the engine thread
    records a first-seen event/histogram name. Individual histogram
    ``observe`` calls stay lockless (they mutate an existing object in
    place); a concurrent snapshot may read a histogram mid-update,
    which is tolerable for a post-mortem."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, _Histogram] = {}

    def inc(self, name: str, n: float = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, v: float):
        with self._lock:
            self.gauges[name] = float(v)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S
                  ) -> _Histogram:
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.get(name)
                if h is None:
                    h = self.histograms[name] = _Histogram(buckets)
        return h

    def publish(self, prefix: str, stats: dict):
        with self._lock:
            for key, v in stats.items():
                name = f"{prefix}.{key}"
                if v is None:
                    # a stat that went back to None (e.g. percentiles
                    # after clear_finished) must not leave its stale
                    # pre-reset value in the registry/export
                    self.counters.pop(name, None)
                    self.gauges.pop(name, None)
                    continue
                if isinstance(v, bool):
                    continue
                if isinstance(v, (int, np.integer)):
                    self.counters[name] = int(v)
                elif isinstance(v, (float, np.floating)):
                    self.gauges[name] = float(v)

    def value(self, name: str):
        with self._lock:
            if name in self.counters:
                return self.counters[name]
            return self.gauges.get(name)

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "histograms": {k: h.snapshot()
                                   for k, h in self.histograms.items()}}

    def to_openmetrics(self) -> str:
        """The registry as OpenMetrics/Prometheus text (counters with
        the ``_total`` suffix, gauges, cumulative-bucket histograms,
        terminated by ``# EOF``). Pure host formatting — scrapeable by
        any Prometheus-compatible collector."""
        return openmetrics_text(self.snapshot())


def _om_name(name: str) -> str:
    """Sanitize a dotted registry name into the OpenMetrics charset
    ([a-zA-Z0-9_:], non-digit first)."""
    s = "".join(ch if (ch.isalnum() and ch.isascii()) or ch in "_:"
                else "_" for ch in str(name))
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def _om_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


def openmetrics_text(snapshot: dict) -> str:
    """Format a ``MetricsRegistry.snapshot()`` dict as OpenMetrics /
    Prometheus text exposition."""
    lines: List[str] = []
    for name, v in sorted((snapshot.get("counters") or {}).items()):
        n = _om_name(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n}_total {_om_num(v)}")
    for name, v in sorted((snapshot.get("gauges") or {}).items()):
        n = _om_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_om_num(v)}")
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        n = _om_name(name)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        counts = list(h.get("counts", ()))
        buckets = list(h.get("buckets", ()))
        for b, c in zip(buckets, counts):
            cum += int(c)
            lines.append(f'{n}_bucket{{le="{_om_num(b)}"}} {cum}')
        if counts:
            cum += int(counts[-1])        # the overflow slot
        lines.append(f'{n}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{n}_sum {_om_num(h.get('sum', 0.0))}")
        lines.append(f"{n}_count {int(h.get('n', 0))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class CompileWatch:
    """Per-family ledger of program keys seen, and the sealed-set
    sentinel. ``records`` holds one dict per compile: family, key, shape
    signature, wall seconds, whether the set was sealed, and the
    family's registration info. Bound to a tracer (``bind``), each
    compile is also a ``compile`` span on the engine's pid and counts in
    ``compile.*``; an unexpected one fires ``unexpected_recompile``."""

    MAX_RECORDS = 512

    def __init__(self, tracer: Optional["Tracer"] = None):
        self.tracer = tracer
        self.metrics = (tracer.metrics if tracer is not None
                        else MetricsRegistry())
        self.pid = 0
        self.sealed = False
        self.compiles = 0
        self.unexpected_recompiles = 0
        self.records: List[dict] = []
        self._families: Dict[str, dict] = {}

    def bind(self, tracer: Optional["Tracer"], pid: int = 0):
        """(Re)attach the tracer and its registry, and the replica pid
        (``ServingEngine.set_telemetry``)."""
        self.tracer = tracer
        if tracer is not None:
            self.metrics = tracer.metrics
        self.pid = int(pid)

    def register(self, family: str, **info):
        """Track one program family; ``info`` rides every record."""
        self._families[family] = {"keys": set(), "info": dict(info)}

    @property
    def families(self) -> List[str]:
        return list(self._families)

    @staticmethod
    def signature_of(args, limit: int = 200) -> str:
        """Compact dtype[shape] signature of a program's operands (numpy
        arrays or tensors), e.g. ``i4[2x3],f4[4]``."""
        parts = []
        for a in args:
            if not (hasattr(a, "shape") and hasattr(a, "dtype")):
                continue
            dt = a.dtype
            if not isinstance(dt, np.dtype):
                dt = np.dtype(str(dt).replace("torch.", ""))
            shape = "x".join(str(int(d)) for d in a.shape)
            parts.append(f"{dt.str.lstrip('<>|=')}[{shape}]")
        sig = ",".join(parts)
        return sig if len(sig) <= limit else sig[:limit] + "..."

    def seen(self, family: str, key) -> bool:
        return key in self._families[family]["keys"]

    def observe(self, family: str, key, t0: float, t1: float, args=()
                ) -> "tuple[int, int]":
        """Note that ``key`` of ``family`` ran in [t0, t1]. Returns
        (new compiles, unexpected compiles): (0, 0) for a key seen
        before, (1, 0) for a new one, (1, 1) for a new one after
        ``seal()``."""
        fam = self._families[family]
        if key in fam["keys"]:
            return 0, 0
        fam["keys"].add(key)
        wall = max(0.0, float(t1) - float(t0))
        rec = {"family": family, "key": key,
               "signature": self.signature_of(args),
               "wall_s": wall, "sealed": self.sealed}
        rec.update(fam["info"])
        self.compiles += 1
        if len(self.records) < self.MAX_RECORDS:
            self.records.append(rec)
        m = self.metrics
        m.inc("compile.total")
        m.inc(f"compile.{family}")
        m.histogram("compile.wall_s").observe(wall)
        if self.tracer is not None:
            attrs = {k: (str(v) if k == "key" else v)
                     for k, v in rec.items() if k != "wall_s"}
            self.tracer.span("compile", None, t0, t1, pid=self.pid,
                             **attrs)
        unexpected = int(self.sealed)
        if unexpected:
            self.unexpected_recompiles += 1
            m.inc("compile.unexpected")
            if self.tracer is not None:
                self.tracer.event("unexpected_recompile", pid=self.pid,
                                  family=family,
                                  signature=rec["signature"])
        return 1, unexpected

    def seal(self):
        """Declare the program set complete."""
        self.sealed = True
        self.metrics.set_gauge("compile.sealed", 1.0)
        if self.tracer is not None:
            self.tracer.event("programs_sealed", pid=self.pid,
                              families=len(self._families))


@dataclass
class SLOPolicy:
    """One declared latency objective over a traffic class: "p99 TTFT
    under ``ttft_p99_s`` and p99 ITL under ``itl_p99_s`` for requests
    matched by ``class_selector``" (None targets are unmonitored; a
    None selector matches all traffic). ``class_selector`` receives a
    small attrs dict ({"adapter_id": ..., "priority": ...}) so classes
    can be cut by tenant or priority without the monitor knowing the
    Request type."""
    name: str
    ttft_p99_s: Optional[float] = None
    itl_p99_s: Optional[float] = None
    class_selector: Optional[Callable[[dict], bool]] = None
    quantile: float = 0.99


class SLOMonitor:
    """Sliding-window SLO evaluation with multi-window burn rates.

    Samples arrive timestamped from the engine's collection paths
    (``observe``; ttft once per request, itl per delivered token with a
    count so a T-token chunk is one append). ``evaluate`` computes, per
    policy and metric, the observed quantile plus the BURN RATE of each
    window — (violating fraction) / (allowed fraction, 1 - quantile) —
    the SRE error-budget form: burn 1.0 spends the budget exactly,
    14.4x on a 1h window is the classic page threshold. A policy is
    ``violating`` when both the shortest and longest populated windows
    burn above 1.0 (the multi-window AND: a transient spike or a stale
    long tail alone doesn't page). ``headroom`` is (target - pXX) /
    target over the longest populated window, the per-replica scalar
    the fleet Router rolls up for SLO-aware routing (1.0 = idle/no
    data, negative = violating by that relative margin).

    Deterministic: tests drive it with synthetic timestamps (``now=``);
    the engine feeds perf_counter."""

    DEFAULT_WINDOWS_S = (60.0, 300.0, 1800.0)
    METRICS = ("ttft", "itl")

    def __init__(self, policies, windows_s: Optional[Sequence[float]]
                 = None, max_samples: int = 4096):
        if isinstance(policies, SLOPolicy):
            policies = [policies]
        self.policies: List[SLOPolicy] = list(policies)
        names = [p.name for p in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO policy names: {names}")
        self.windows = tuple(sorted(
            float(w) for w in (windows_s or self.DEFAULT_WINDOWS_S)))
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(f"windows_s must be positive: "
                             f"{self.windows}")
        self.max_samples = int(max_samples)
        # (policy, metric) -> deque of (ts, value, count); bounded like
        # the ITL reservoir so unbounded runs stay O(k)
        self._dq: Dict[tuple, deque] = {
            (p.name, m): deque(maxlen=self.max_samples)
            for p in self.policies for m in self.METRICS}

    @staticmethod
    def coerce_policies(slo) -> List[SLOPolicy]:
        """Normalize the ``slo=`` constructor surface (None / one
        policy / a monitor whose policies serve as the template / a
        sequence of policies) into a plain policy list — shared by
        ServingEngine and Router so the accepted forms can't drift."""
        if slo is None:
            return []
        if isinstance(slo, SLOMonitor):
            return list(slo.policies)
        if isinstance(slo, SLOPolicy):
            return [slo]
        return list(slo)

    @staticmethod
    def _target(p: SLOPolicy, metric: str) -> Optional[float]:
        return p.ttft_p99_s if metric == "ttft" else p.itl_p99_s

    def observe(self, metric: str, value: float, attrs: Optional[dict]
                = None, n: int = 1, now: Optional[float] = None):
        if metric not in self.METRICS:
            raise ValueError(f"metric must be one of {self.METRICS}, "
                             f"got {metric!r}")
        now = time.perf_counter() if now is None else float(now)
        for p in self.policies:
            if self._target(p, metric) is None:
                continue
            sel = p.class_selector
            if sel is not None and not sel(attrs or {}):
                continue
            self._dq[(p.name, metric)].append(
                (now, float(value), int(n)))

    def evaluate(self, now: Optional[float] = None) -> dict:
        now = time.perf_counter() if now is None else float(now)
        policies: Dict[str, dict] = {}
        any_viol = False
        heads: List[float] = []
        for p in self.policies:
            metrics: Dict[str, dict] = {}
            p_viol = False
            p_heads: List[float] = []
            for metric in self.METRICS:
                target = self._target(p, metric)
                if target is None:
                    continue
                samples = list(self._dq[(p.name, metric)])
                allowed = max(1e-9, 1.0 - p.quantile)
                wins: Dict[str, dict] = {}
                burns: List[float] = []
                for w in self.windows:
                    vals = [(v, k) for ts, v, k in samples
                            if now - ts <= w]
                    nn = sum(k for _, k in vals)
                    bad = sum(k for v, k in vals if v > target)
                    burn = ((bad / nn) / allowed) if nn else None
                    wins[f"{int(w)}s"] = {
                        "n": nn, "violations": bad,
                        "burn_rate": (round(burn, 4)
                                      if burn is not None else None)}
                    if nn:
                        burns.append(burn)
                pxx = None
                longest = [(v, k) for ts, v, k in samples
                           if now - ts <= self.windows[-1]]
                if longest:
                    arr = np.repeat([v for v, _ in longest],
                                    [k for _, k in longest])
                    pxx = float(np.quantile(arr, p.quantile))
                viol = (len(burns) > 0 and burns[0] > 1.0
                        and burns[-1] > 1.0)
                head = (None if pxx is None
                        else (target - pxx) / target)
                metrics[metric] = {
                    "target_s": target,
                    "p_s": (round(pxx, 6) if pxx is not None else None),
                    "windows": wins, "violating": viol,
                    "headroom": (round(head, 4)
                                 if head is not None else None)}
                p_viol = p_viol or viol
                if head is not None:
                    p_heads.append(head)
            head = min(p_heads) if p_heads else 1.0
            policies[p.name] = {"metrics": metrics,
                                "violating": p_viol,
                                "headroom": round(head, 4)}
            any_viol = any_viol or p_viol
            heads.append(head)
        return {"policies": policies, "violating": any_viol,
                "min_headroom": (round(min(heads), 4)
                                 if heads else 1.0)}

    def reset(self):
        """Drop every window (the clear_finished contract: post-warmup
        stats reflect only real traffic)."""
        for dq in self._dq.values():
            dq.clear()


class Tracer:
    """Flight recorder + span tracer. See the module docstring for the
    taxonomy; the record stream is a bounded deque of small dicts:

    - ``{"kind": "begin"/"end", "name": "request", "trace": id, ...}``
      — request lifecycle (async span endpoints);
    - ``{"kind": "span", "name": phase, "trace": id, "ts": t0,
      "dur": seconds, ...}`` — one completed per-life phase;
    - ``{"kind": "event", "name": ..., ...}`` — per-step instants.

    Timestamps are ``time.perf_counter()`` values (the engine's own
    clock); export rebases them to microseconds from the tracer's
    construction. Thread-safe (the watchdog thread reads ``summary()``
    while the engine appends)."""

    DEFAULT_CAPACITY = 1 << 16

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 metrics: Optional[MetricsRegistry] = None,
                 id_base: int = 1):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.appended = 0
        self.metrics = metrics or MetricsRegistry()
        # id_base: a worker-process Tracer starts its trace
        # ids at a per-(replica, generation) disjoint base, so records
        # forwarded over the transport and ingested into the parent
        # ring can never collide with the parent's own ids (default 1:
        # single-process behavior unchanged)
        self._ids = itertools.count(int(id_base))
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------
    def _record(self, rec: dict):
        with self._lock:
            self._ring.append(rec)
            self.appended += 1

    @property
    def dropped(self) -> int:
        """Records that fell off the ring (flight-recorder semantics:
        the newest ``capacity`` records always survive)."""
        return self.appended - len(self._ring)

    def begin_request(self, req_id: int, tenant=None, replica: int = 0,
                      **attrs) -> int:
        """Open one request-lifetime async span; returns its trace id
        (propagate it through adopt_request so a migrated request stays
        ONE span)."""
        tid = next(self._ids)
        args = {"req_id": int(req_id), "replica": int(replica)}
        if tenant is not None:
            args["tenant"] = str(tenant)
        args.update(attrs)
        self._record({"kind": "begin", "name": "request", "trace": tid,
                      "pid": FLEET_PID, "ts": time.perf_counter(),
                      "args": args})
        self.metrics.inc("trace.requests")
        return tid

    def end_request(self, trace_id: Optional[int], state: str,
                    replica: int = 0, **attrs):
        if trace_id is None:
            return
        args = {"state": state, "replica": int(replica)}
        args.update(attrs)
        self._record({"kind": "end", "name": "request",
                      "trace": int(trace_id), "pid": FLEET_PID,
                      "ts": time.perf_counter(), "args": args})
        self.metrics.inc(f"trace.requests_{state}")

    def reopen_request(self, trace_id: Optional[int]) -> bool:
        """Rescind the most recent end record of ``trace_id`` — the
        fleet Router calls this when it migrates a request whose
        fault-burst FAILURE already closed the span (the engine failed
        it before the breaker tripped): the migration supersedes the
        terminal state, so the span must stay open until the adopted
        continuation ends it (one continuous span across replicas).
        Returns False when no end record is in the ring (it either
        never existed or already fell off)."""
        if trace_id is None:
            return False
        with self._lock:
            for r in reversed(self._ring):
                if r["kind"] == "end" and r["trace"] == trace_id:
                    self._ring.remove(r)
                    self.appended -= 1
                    state = r["args"].get("state")
                    if state:
                        self.metrics.inc(f"trace.requests_{state}", -1)
                    return True
        return False

    def span(self, name: str, trace_id: Optional[int], t0: float,
             t1: float, pid: int = 0, **attrs):
        """One completed per-life phase slice [t0, t1] (perf_counter
        seconds) on the replica track ``pid``."""
        self._record({"kind": "span", "name": name,
                      "trace": (int(trace_id) if trace_id is not None
                                else None),
                      "pid": int(pid), "ts": float(t0),
                      "dur": max(0.0, float(t1) - float(t0)),
                      "args": attrs})
        self.metrics.inc(f"spans.{name}")
        self.metrics.histogram(f"span.{name}_s").observe(
            max(0.0, float(t1) - float(t0)))

    def event(self, name: str, trace: Optional[int] = None,
              pid: int = 0, **attrs):
        """One per-step instant (dispatch, retry, injected fault,
        breaker strike, kv alloc/evict/splice/rollback, ...)."""
        self._record({"kind": "event", "name": name,
                      "trace": (int(trace) if trace is not None
                                else None),
                      "pid": int(pid), "ts": time.perf_counter(),
                      "args": attrs})
        self.metrics.inc(f"events.{name}")

    def counter(self, name: str, value, pid: int = 0):
        """One counter-track sample: exports as a Perfetto
        ``ph: "C"`` event so the value renders as a resource TIMELINE
        next to the request spans (running slots, free blocks, queue
        depth, ...). The latest value also lands in the registry as a
        ``track.*`` gauge (per-replica suffix off the pid), so the
        OpenMetrics export carries the instantaneous view."""
        v = float(value)
        self._record({"kind": "counter", "name": name, "trace": None,
                      "pid": int(pid), "ts": time.perf_counter(),
                      "args": {"value": v}})
        suffix = ("" if pid == 0
                  else ".fleet" if pid == FLEET_PID
                  else f".r{int(pid)}")
        self.metrics.set_gauge(f"track.{name}{suffix}", v)

    # -- cross-process forwarding ---------------------------------------------
    def drain_since(self, mark: int) -> tuple:
        """``(records appended since `mark`, new mark)`` — the worker
        side of transport telemetry forwarding: each step/stats reply
        piggybacks only the NEW records (reconstructed from the ring
        tail via the ``appended`` counter; records that already fell
        off the ring are lost exactly like flight-recorder semantics
        lose them locally)."""
        with self._lock:
            new = self.appended - int(mark)
            if new <= 0:
                return [], self.appended
            recs = list(self._ring)
            return (recs[-new:] if new < len(recs) else recs,
                    self.appended)

    def ingest(self, records: List[dict], ts_offset: float = 0.0):
        """Append records forwarded from ANOTHER process's Tracer into
        this ring, mirroring each kind's registry side-effects (the
        merged registry / validate_trace / trace_report views must
        agree with a single-process run). ``ts_offset`` shifts worker
        timestamps onto the parent clock — 0.0 on Linux, where
        perf_counter is CLOCK_MONOTONIC and shared across processes."""
        for r in records:
            rec = dict(r)
            if ts_offset:
                rec["ts"] = float(rec["ts"]) + ts_offset
            self._record(rec)
            kind, name = rec.get("kind"), rec.get("name")
            if kind == "begin":
                self.metrics.inc("trace.requests")
            elif kind == "end":
                state = rec.get("args", {}).get("state")
                if state:
                    self.metrics.inc(f"trace.requests_{state}")
            elif kind == "span":
                self.metrics.inc(f"spans.{name}")
                self.metrics.histogram(f"span.{name}_s").observe(
                    max(0.0, float(rec.get("dur", 0.0))))
            elif kind == "event":
                self.metrics.inc(f"events.{name}")
            elif kind == "counter":
                pid = int(rec.get("pid", 0))
                suffix = ("" if pid == 0
                          else ".fleet" if pid == FLEET_PID
                          else f".r{pid}")
                self.metrics.set_gauge(
                    f"track.{name}{suffix}",
                    float(rec["args"]["value"]))

    # -- reading -------------------------------------------------------------
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def summary(self, last: int = 25) -> str:
        """Human-readable tail of the flight recorder (the watchdog
        appends this to its hang report)."""
        recs = self.records()
        lines = [f"flight recorder: {self.appended} records "
                 f"({self.dropped} dropped, capacity {self.capacity}); "
                 f"last {min(last, len(recs))}:"]
        for r in recs[-last:]:
            t = r["ts"] - self._t0
            extra = f" dur={r['dur'] * 1e3:.2f}ms" if "dur" in r else ""
            tidp = f" trace={r['trace']}" if r.get("trace") else ""
            lines.append(f"  +{t:9.3f}s [{r['kind']}] {r['name']}"
                         f"{tidp} pid={r['pid']}{extra} {r['args']}")
        return "\n".join(lines) + "\n"

    # -- export --------------------------------------------------------------
    def _us(self, t: float) -> float:
        return max(0.0, (t - self._t0) * 1e6)

    def export(self, path: str) -> str:
        """Write the flight recorder as Chrome-trace / Perfetto JSON
        (plus the metrics-registry snapshot under ``"metrics"``).
        Returns ``path``."""
        recs = self.records()
        evts: List[dict] = []
        pids = sorted({r["pid"] for r in recs})
        for pid in pids:
            name = ("fleet" if pid == FLEET_PID
                    else f"replica{pid}")
            evts.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "ts": 0,
                         "args": {"name": name}})
        for r in recs:
            tid = r["trace"] if r.get("trace") is not None else 0
            if r["kind"] == "begin":
                evts.append({"ph": "b", "cat": "request",
                             "id": str(r["trace"]),
                             "name": f"req{r['args'].get('req_id', '')}",
                             "pid": r["pid"], "tid": tid,
                             "ts": self._us(r["ts"]),
                             "args": r["args"]})
            elif r["kind"] == "end":
                evts.append({"ph": "e", "cat": "request",
                             "id": str(r["trace"]), "name": "request",
                             "pid": r["pid"], "tid": tid,
                             "ts": self._us(r["ts"]),
                             "args": r["args"]})
            elif r["kind"] == "span":
                evts.append({"ph": "X", "cat": "phase",
                             "name": r["name"], "pid": r["pid"],
                             "tid": tid, "ts": self._us(r["ts"]),
                             "dur": r["dur"] * 1e6,
                             "args": r["args"]})
            elif r["kind"] == "counter":
                evts.append({"ph": "C", "cat": "track",
                             "name": r["name"], "pid": r["pid"],
                             "tid": 0, "ts": self._us(r["ts"]),
                             "args": r["args"]})
            else:
                evts.append({"ph": "i", "cat": "step",
                             "name": r["name"], "pid": r["pid"],
                             "tid": tid, "ts": self._us(r["ts"]),
                             "s": "t", "args": r["args"]})
        doc = {"traceEvents": evts, "displayTimeUnit": "ms",
               "otherData": {"dropped_records": self.dropped,
                             "appended_records": self.appended},
               "metrics": self.metrics.snapshot()}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
