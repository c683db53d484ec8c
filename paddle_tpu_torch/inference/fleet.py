"""Fleet serving: dp replicas behind a health-checked Router.
Counterpart: ``paddle_tpu/inference/fleet.py``.

One ServingEngine is one failure domain. The Router owns R independent
replicas (each a full ServingEngine) and adds the replica-level half:

- prefix-affinity routing: each admission asks every eligible replica's
  prefix index (``PagedKVCache.match_prefix``, a host-side hash walk)
  for its cached coverage of the prompt and routes to the longest; ties
  (and the no-coverage case) break least-loaded, then lowest index, so
  routing is deterministic. A winner that sheds (``EngineOverloaded``)
  spills to the next candidate; when every replica refuses, the fleet
  sheds.
- a circuit breaker per replica: after each replica step the Router
  reads new retry exhaustions (``dispatch_exhaustions``), a step wall
  past ``stall_timeout_s`` and a step exception. Each exhaustion is one
  strike (a stall or exception at least one); a clean step with device
  activity resets the count, an idle step proves nothing; at
  ``breaker_threshold`` strikes the replica is wedged.
- drain-and-migrate failover: a wedged replica's live requests, and
  those its fault burst just failed, are harvested (prompt, sampling,
  generated history), cancelled locally (host-side unwind only) and
  re-enqueued on healthy replicas through
  ``ServingEngine.adopt_request``: the history is prefilled again by the
  no-sample programs (no key drawn) and decode resumes from the last
  token, so greedy streams are token-identical across the move.
- probation: ``cooldown_steps`` after a wedge the replica re-enters
  routing on probation; one strike wedges it again, ``probation_steps``
  clean steps make it healthy.
- transports (``inference/transport.py``): ``"inproc"`` (the default)
  steps the engines in this process; ``"process"`` runs each in a
  spawned worker behind an RPC pipe, with two more signals for the
  breaker (a missed heartbeat, the process's exit). As a dead worker's
  memory is gone, the Router keeps a journal per request (prompt,
  sampling, delivered tokens, trace id), extended exactly once at each
  step reply, and a failover rebuilds every request in flight from it.
  A supervisor respawns dead workers (a fresh engine, the warmup and
  seal calls replayed, then probation).

Replicas never talk during a step: affinity is a host-side lookup and
migration a host-side re-enqueue. At ``tp=1`` every replica builds its
engine on the engine's device (``engine_kwargs["device"]``; None:
cuda), so a dp fleet on one card shares it. At ``tp > 1`` replica r is a
tp engine on row r of ``SpecLayout.fleet_device_slices(dp, tp,
devices)``: disjoint slices of ``devices`` (None: the visible cards),
where a device may repeat (``["cuda:0"] * 4`` holds a dp 2 x tp 2 fleet
on one card). A spawned worker computes its own row.

Usage::

    from paddle_tpu_torch.inference import Router
    router = Router(model, dp=2, max_batch_size=8)
    fid = router.add_request(prompt_ids, SamplingParams(...))
    while router.step():
        pass
    tokens = router.result(fid)

Greedy requests give the same tokens whichever replica serves them and
across any number of migrations (every replica holds the same weights;
migration prefills without sampling). Sampled requests stay correct per
request but are not reproducible across replicas: each engine owns its
key stream, as under preemption.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.spec_layout import SpecLayout
from ..utils.telemetry import FLEET_PID, Reservoir, SLOMonitor, SLOPolicy
from .serving import (EngineOverloaded, SamplingParams, ServingEngine,
                      _normalize_prompt)
from .transport import (InProcTransport, ProcTransport, RequestView,
                        TransportError, WorkerDied, WorkerSpec,
                        engine_from_model, model_state)

__all__ = ["Router", "Replica"]

# journal states considered live (the engine's non-terminal states);
# terminal entries stop being acked and are pruned by clear_finished
_LIVE_STATES = ("queued", "prefilling", "running")


@dataclass
class Replica:
    """One engine plus its health record (``router.replicas``)."""
    idx: int
    engine: ServingEngine
    state: str = "healthy"          # healthy | probation | wedged
    strikes: int = 0                # consecutive faulty steps
    wedges: int = 0                 # times this replica tripped
    wedged_at: Optional[int] = None  # router step of the last wedge
    probation_clean: int = 0        # clean steps since probation began
    # engine.dispatch_exhaustions watermark (delta per step = faults)
    exh_mark: int = 0
    # engine.device_dispatches watermark: a step with NO device
    # activity is evidence of nothing — it neither strikes nor resets
    disp_mark: int = 0
    # engine req_ids already failed BEFORE the current strike burst:
    # at drain time only requests failed DURING the burst migrate (a
    # request that failed long ago was already observed as failed by
    # the caller — resurrecting it would change a delivered answer).
    # Rebuilt lazily: valid while engine.failed == snap_failed_cnt,
    # so the steady state (no failures) never rescans _done.
    # Remote replicas store journal FIDs here instead of engine rids
    # (the journal is the Router's only authoritative view of a
    # worker it cannot trust to answer)
    burst_failed_mark: frozenset = frozenset()
    snap_failed_cnt: int = 0
    # the transport driving this replica: InProcTransport
    # wraps `engine` (kept live for tests/harnesses); ProcTransport
    # owns a worker process and `engine` is None
    transport: object = None
    # last step's worker-reported load (remote replicas: the counter
    # track must not cost an RPC; in-proc replicas read the engine)
    last_load: int = 0


@dataclass
class _JournalEntry:
    """Router-side delivery journal for ONE fleet request:
    the delivered-token watermark plus last observed state. Together
    with _FleetRequest (prompt, sampling, trace_id) this is everything
    failover needs to reconstruct an in-flight request after a worker
    dies with its memory. ``delivered`` only ever EXTENDS past its
    current length against the reply's ack base — exactly-once no
    matter how many times a step reply crosses the pipe."""
    fid: int
    state: str = "queued"
    delivered: List[int] = None     # type: ignore[assignment]
    error: Optional[str] = None

    def __post_init__(self):
        if self.delivered is None:
            self.delivered = []


@dataclass
class _FleetRequest:
    """Fleet-level request record: which replica currently owns it."""
    fid: int
    prompt: np.ndarray
    sampling: SamplingParams
    replica: int
    rid: int                        # engine-local req_id on `replica`
    t_submit: float = 0.0
    migrations: int = 0
    # telemetry span id: opened by the owning engine's
    # add_request, carried through adopt_request at migration so the
    # whole lifecycle is ONE continuous span across replicas
    trace_id: Optional[int] = None


class Router:
    """R ServingEngine replicas behind prefix-affinity routing, health
    tracking with a circuit breaker, and drain-and-migrate failover.

    Parameters
    ----------
    model : the LlamaForCausalLM or GPTForCausalLM every replica serves
        (each replica's engine builds its own decoder and pool from it,
        a GPT model's through ``PagedGPTDecoder.from_model``). Ignored
        when ``engine_factory`` is given.
    dp : replica count R.
    tp : per-replica tensor-parallel degree; tp > 1 places replica r on
        row r of ``SpecLayout.fleet_device_slices(dp, tp, devices)``.
    devices : the devices of the dp x tp grid (tp > 1 only; None: the
        visible cards).
    affinity : route by longest cached chain-hash coverage (True, the
        default) or purely by load (False).
    breaker_threshold : consecutive faulty steps before a replica is
        declared wedged and drained.
    stall_timeout_s : a single engine step taking longer than this
        counts as a watchdog-stall strike (None disables — CPU test
        meshes stall for compile reasons, not health reasons).
    cooldown_steps : router steps after a wedge before the replica
        re-enters routing on probation (None = stay wedged forever).
    probation_steps : consecutive clean steps that promote a probation
        replica back to healthy.
    engine_factory : optional ``f(replica_idx, devices) ->
        ServingEngine`` (``devices`` is None at tp 1) overriding default
        construction: prebuilt decoders (replicas may share one weight
        tree, each with a pool of its own), per-replica AdapterRegistry
        instances (a registry binds to one engine's pool and must not be
        shared across replicas). With ``transport="process"`` the
        factory is pickled to the worker, so it must be a module-level
        callable.
    transport : ``"inproc"`` (default: engines live in this process)
        or ``"process"`` (each engine in a spawned worker behind an RPC
        pipe, for crash isolation; see ``inference/transport.py``).
    heartbeat_timeout_s : (process transport) heartbeat silence beyond
        this is a breaker strike per step — the liveness signal for a
        hung-but-not-dead worker. None disables.
    rpc_timeout_s / rpc_retries : (process transport) per-RPC deadline
        and bounded retry budget for transient transport faults
        (exactly-once by the worker's reply cache).
    respawn : (process transport) supervisor restart of dead workers —
        fresh engine, replayed warmup/seal, probation re-admission.
    **engine_kwargs : forwarded to every ServingEngine (max_batch_size,
        num_blocks, prefill_chunk, ragged, device, ...). ``devices``
        with tp 1 raises ``ValueError``, as JAX's engine does.
    """

    def __init__(self, model, dp: int = 2, tp: int = 1, *,
                 affinity: bool = True,
                 breaker_threshold: int = 3,
                 stall_timeout_s: Optional[float] = None,
                 cooldown_steps: Optional[int] = None,
                 probation_steps: int = 8,
                 engine_factory: Optional[Callable] = None,
                 transport: str = "inproc",
                 heartbeat_timeout_s: Optional[float] = 10.0,
                 rpc_timeout_s: float = 120.0,
                 rpc_retries: int = 2,
                 respawn: bool = True,
                 tracer=None, slo=None, devices=None,
                 **engine_kwargs):
        dp = int(dp)
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if int(tp) < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if devices is not None and int(tp) == 1:
            raise ValueError(
                "devices= requires tp > 1: a single-chip engine builds on "
                "the default device (the fleet Router passes devices only "
                "for tp-sharded replicas)")
        # per-replica device rows of the canonical dp x tp grid (tp=1
        # replicas share the engine's device)
        slices = (SpecLayout().fleet_device_slices(dp, tp, devices)
                  if int(tp) > 1 else [None] * dp)
        if transport not in ("inproc", "process"):
            raise ValueError(f"transport must be 'inproc' or "
                             f"'process', got {transport!r}")
        self.dp = dp
        self.tp = int(tp)
        self.affinity = bool(affinity)
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.stall_timeout_s = stall_timeout_s
        self.cooldown_steps = (int(cooldown_steps)
                               if cooldown_steps is not None else None)
        self.probation_steps = max(1, int(probation_steps))
        self.transport = transport
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.rpc_retries = int(rpc_retries)
        self.respawn = bool(respawn)
        # telemetry: ONE shared Tracer across the Router and
        # every replica engine — per-request spans carry replica pids
        # and routing/breaker/migration events land on the fleet track,
        # so a migrated request renders as a single continuous span
        # crossing two replica tracks. tracer=None is a bitwise no-op.
        self.tracer = tracer
        # SLO monitoring: `slo` is a sequence of SLOPolicy
        # declarations (or one policy / an SLOMonitor whose policies
        # are taken as the template). Each replica gets its OWN
        # monitor over the shared policy set — windows must be
        # per-replica or one slow replica's tail hides inside the
        # fleet aggregate; stats() rolls the per-replica headrooms up
        # (the SLO-aware-routing input)
        self._slo_policies: List[SLOPolicy] = \
            SLOMonitor.coerce_policies(slo)
        if self._slo_policies and engine_factory is not None:
            # a factory builds its engines itself — Router-level
            # policies would be silently ignored; fail loudly instead
            raise ValueError("pass slo= to the Router only without "
                             "engine_factory (give factory-built "
                             "engines their own SLOMonitor)")
        self.replicas: List[Replica] = []
        spec_model = {}
        if transport == "process" and engine_factory is None:
            # the model crosses the pipe as its config and CPU numpy
            # parameters; each worker builds it on its own device
            spec_model = {"config": model.cfg, "state": model_state(model)}
        for r in range(dp):
            if transport == "process":
                spec = WorkerSpec(
                    factory=engine_factory, dp=dp, tp=self.tp,
                    devices=(None if devices is None
                             else [str(d) for d in devices]),
                    engine_kwargs=dict(engine_kwargs),
                    slo_policies=tuple(self._slo_policies),
                    traced=tracer is not None,
                    torch_threads=torch.get_num_threads(), **spec_model)
                tr = ProcTransport(
                    spec, replica_id=r, tracer=tracer,
                    rpc_timeout_s=self.rpc_timeout_s,
                    rpc_retries=self.rpc_retries)
                self.replicas.append(Replica(r, None, transport=tr))
                continue
            if engine_factory is not None:
                eng = engine_factory(r, slices[r])
            else:
                kw = dict(engine_kwargs)
                if self._slo_policies:
                    kw["slo"] = SLOMonitor(self._slo_policies)
                eng = engine_from_model(model, tp=self.tp,
                                        devices=slices[r], **kw)
            if tracer is not None:
                eng.set_telemetry(tracer, replica_id=r)
            self.replicas.append(Replica(r, eng,
                                         transport=InProcTransport(
                                             eng)))
        self._requests: Dict[int, _FleetRequest] = {}
        # per-request delivery journal: authoritative for
        # BOTH transports (uniform gauges + acks); only the process
        # transport depends on it for correctness
        self._journal: Dict[int, _JournalEntry] = {}
        self._fids = itertools.count()
        self._step_no = 0
        self._closed = False
        # routing / robustness counters (reset by clear_finished)
        self.routed_requests = 0
        self.affinity_hits = 0
        self.spills = 0
        self.failovers = 0
        self.migrated_requests = 0
        self.failed_migrations = 0
        self.shed_requests = 0
        # fleet-process counters (reset by clear_finished)
        self.worker_exits = 0
        self.worker_restarts = 0
        self.heartbeat_misses = 0

    # -- routing policy ------------------------------------------------------
    def _eligible(self) -> List[Replica]:
        return [rep for rep in self.replicas if rep.state != "wedged"]

    @staticmethod
    def _load(eng: ServingEngine) -> int:
        """Host-side load proxy: live requests (queued + slotted)."""
        return len(eng._queue) + sum(1 for s in eng._slots
                                     if s is not None)

    @staticmethod
    def _coverage(eng: ServingEngine, prompt, salt) -> int:
        """Cached chain-hash coverage of `prompt` on this replica, in
        tokens: the prefix index walk, host side only."""
        if not eng.prefix_caching:
            return 0
        cache = eng.dec.cache
        return len(cache.match_prefix(prompt, salt)) * cache.block_size

    def _cov_of(self, rep: Replica, prompt, salt) -> int:
        """Transport coverage probe, fault-tolerant: a dying remote
        replica answers 0 (it will be wedged by the next step; routing
        must not crash on it)."""
        try:
            return rep.transport.match_coverage(prompt, salt)
        except TransportError:
            return 0

    def _load_of(self, rep: Replica) -> int:
        try:
            return rep.transport.load()
        except TransportError:
            return 1 << 30      # dying remote: route anywhere else

    def _ranked(self, prompt, sp: SamplingParams,
                exclude: Sequence[int] = ()
                ) -> Tuple[List[Replica], Dict[int, int]]:
        """Admission order: longest coverage first (affinity), ties —
        and the affinity=False mode — by (load, replica idx). Fully
        deterministic: equal fleets route equal traffic equally (the
        process transport's coverage/load probes are exact RPCs, so an
        inproc fleet and a process fleet route identically)."""
        cands = [rep for rep in self._eligible()
                 if rep.idx not in exclude]
        cov = {rep.idx: (self._cov_of(rep, prompt, sp.adapter_id)
                         if self.affinity else 0)
               for rep in cands}
        return sorted(cands, key=lambda rep: (-cov[rep.idx],
                                              self._load_of(rep),
                                              rep.idx)), cov

    def add_request(self, prompt, sampling: Optional[SamplingParams]
                    = None) -> int:
        """Route one admission through the fleet. Returns a FLEET
        request id (stable across migrations). Raises EngineOverloaded
        only when EVERY eligible replica sheds it (per-replica queue
        caps and deadline estimates are the engine's shedding, consulted
        replica by replica — a saturated affinity winner spills to the
        next candidate instead of shedding)."""
        sp = sampling or SamplingParams()
        prompt = _normalize_prompt(prompt)
        order, cov = self._ranked(prompt, sp)
        if not order:
            self.shed_requests += 1
            if self.tracer is not None:
                self.tracer.event("fleet_shed", pid=FLEET_PID,
                                  reason="all_wedged")
            raise EngineOverloaded("fleet has no eligible replica "
                                   "(all wedged)")
        last_exc = invalid = None
        for pos, rep in enumerate(order):
            try:
                rid, tid = rep.transport.add_request(prompt, sp)
            except EngineOverloaded as e:
                last_exc = e
                continue
            except (KeyError, ValueError) as e:
                # a per-replica validation refusal (engine_factory fleets
                # may be heterogeneous: an adapter registered on only
                # some replicas, differing pool geometry) — try the
                # next candidate; if EVERY replica refuses this way the
                # request is genuinely invalid and the first error is
                # the honest one to surface
                invalid = invalid or e
                continue
            except TransportError as e:
                # a dying remote replica refuses like a saturated one:
                # spill to the next candidate (the breaker wedges it
                # on its own evidence at the next step)
                last_exc = e
                continue
            fid = next(self._fids)
            rec = _FleetRequest(fid, prompt, sp, rep.idx, rid,
                                t_submit=time.perf_counter())
            rec.trace_id = tid
            self._requests[fid] = rec
            self._journal[fid] = _JournalEntry(fid)
            self.routed_requests += 1
            if cov.get(rep.idx, 0) > 0:
                self.affinity_hits += 1
            if pos > 0:
                self.spills += 1
            if self.tracer is not None:
                self.tracer.event(
                    "route", trace=rec.trace_id, pid=FLEET_PID,
                    fid=fid, replica=rep.idx,
                    coverage=int(cov.get(rep.idx, 0)), spill=pos)
            return fid
        if invalid is not None and last_exc is None:
            raise invalid          # rejected everywhere: caller error
        self.shed_requests += 1
        if self.tracer is not None:
            self.tracer.event("fleet_shed", pid=FLEET_PID,
                              reason="saturated")
        raise EngineOverloaded(
            f"fleet saturated: all {len(order)} eligible replica(s) "
            f"shed the request (last: {last_exc or invalid})")

    # -- request surface -----------------------------------------------------
    def _record(self, fid: int) -> _FleetRequest:
        rec = self._requests.get(fid)
        if rec is None:
            raise KeyError(f"unknown fleet request {fid}")
        return rec

    def _owner(self, fid: int) -> Replica:
        return self.replicas[self._record(fid).replica]

    def _journal_view(self, fid: int) -> Optional[RequestView]:
        """Reconstruct a request view from the journal — the fallback
        when the owning WORKER's memory is gone (died, or respawned
        fresh). Exact for terminal requests: the terminal delivery
        carried every remaining token before the state flipped."""
        rec = self._requests.get(fid)
        je = self._journal.get(fid)
        if rec is None or je is None:
            return None
        return RequestView(req_id=rec.rid, state=je.state,
                           out_tokens=list(je.delivered),
                           error=je.error, trace_id=rec.trace_id)

    def request(self, fid: int):
        """The current owner's Request record (live or terminal). For
        a process-transport replica this is a RequestView (same duck
        type); if the owning worker died or was respawned, the view
        is reconstructed from the Router's journal."""
        rec = self._record(fid)
        rep = self.replicas[rec.replica]
        if not rep.transport.remote:
            req = rep.engine._find_request(rec.rid)
            if req is None:
                raise KeyError(f"fleet request {fid}: engine record "
                               f"{rec.rid} gone (cleared?)")
            return req
        # TERMINAL entries answer from the journal, never the worker:
        # the terminal delivery carried every remaining token, and a
        # RESPAWNED worker's fresh engine restarts its req_id counter
        # at 0 — the stale rec.rid may now name a DIFFERENT request
        je = self._journal.get(fid)
        if je is not None and je.state not in _LIVE_STATES:
            return self._journal_view(fid)
        try:
            view = rep.transport.view(rec.rid)
        except TransportError:
            view = None
        if view is not None:
            return view
        view = self._journal_view(fid)
        if view is not None:
            return view
        raise KeyError(f"fleet request {fid}: engine record "
                       f"{rec.rid} gone (cleared?)")

    def result(self, fid: int) -> np.ndarray:
        rec = self._record(fid)
        rep = self.replicas[rec.replica]
        if not rep.transport.remote:
            return rep.engine.result(rec.rid)
        # journal-first for terminal states: the delivered watermark
        # IS the full output, and it cannot alias a respawned
        # worker's recycled req_id the way rec.rid can
        je = self._journal.get(fid)
        if je is not None and je.state not in _LIVE_STATES:
            return np.asarray(je.delivered, np.int32)
        try:
            return rep.transport.result(rec.rid)
        except (KeyError, TransportError):
            raise KeyError(f"fleet request {fid}: result not "
                           f"available (rid {rec.rid})")

    def migrations(self, fid: int) -> int:
        return self._record(fid).migrations

    def cancel(self, fid: int) -> bool:
        rec = self._record(fid)
        rep = self.replicas[rec.replica]
        if rep.transport.remote:
            je = self._journal.get(fid)
            if je is not None and je.state not in _LIVE_STATES:
                # terminal per the journal: the inproc False-on-
                # terminal contract, without risking a stale rec.rid
                # cancelling a respawned worker's recycled req_id
                return False
        return rep.transport.cancel(rec.rid)

    @property
    def has_work(self) -> bool:
        """Work remains on some replica the Router will still step —
        non-wedged ones always; wedged ones only if probation can
        revive them (their live queue was drained at wedge time, so
        this is almost always the non-wedged term)."""
        return any(rep.transport.has_work() for rep in self.replicas
                   if rep.state != "wedged"
                   or self.cooldown_steps is not None)

    # -- health / failover ---------------------------------------------------
    def _failed_rids(self, eng: ServingEngine) -> frozenset:
        return frozenset(rid for rid, r in eng._done.items()
                         if r.state == "failed")

    def _failed_fids(self, rep: Replica) -> frozenset:
        """Journal fids already failed on `rep` — the remote replica's
        burst snapshot (its engine cannot be trusted to answer when
        the burst is a dying process)."""
        return frozenset(
            fid for fid, je in self._journal.items()
            if je.state == "failed"
            and (rec := self._requests.get(fid)) is not None
            and rec.replica == rep.idx)

    def _acks_for(self, rep: Replica
                  ) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(acks, rid->fid) for one replica's step RPC: every live
        journal entry it owns, acked at its delivered watermark."""
        acks: Dict[int, int] = {}
        ridmap: Dict[int, int] = {}
        for fid, je in self._journal.items():
            if je.state not in _LIVE_STATES:
                continue
            rec = self._requests.get(fid)
            if rec is None or rec.replica != rep.idx:
                continue
            acks[rec.rid] = len(je.delivered)
            ridmap[rec.rid] = fid
        return acks, ridmap

    def _apply_deliveries(self, deliveries, ridmap: Dict[int, int]):
        """Extend the journal exactly once per token: a delivery's
        tokens start at its echoed ack base, so extension happens only
        past the CURRENT watermark — idempotent under RPC retry (the
        same reply applied twice extends nothing the second time)."""
        for d in deliveries:
            fid = ridmap.get(d["rid"])
            if fid is None:
                continue
            je = self._journal.get(fid)
            if je is None:
                continue
            have = len(je.delivered)
            base = d["base"]
            toks = d["tokens"]
            if base <= have < base + len(toks):
                je.delivered.extend(toks[have - base:])
            if d["state"] != "gone":
                je.state = d["state"]
                je.error = d["error"]

    def _strike(self, rep: Replica, amount: int,
                prestep_mark: frozenset):
        """Accumulate fault evidence. `amount` is the step's retry-
        exhaustion count (each exhaustion is one consecutive
        _device_call failure — a step that exhausts three dispatches is
        three strikes, not one), floored at 1 for stall/exception
        strikes. Strikes reset only on a CLEAN step with device
        activity, so a replica that killed its whole queue and went
        idle keeps its evidence until the breaker decides."""
        if rep.strikes == 0:
            # burst starts: the PRE-step snapshot of what had already
            # failed — taken before this step's own casualties, so the
            # drain migrates everything THIS burst killed and nothing
            # a caller already observed as failed
            rep.burst_failed_mark = prestep_mark
        rep.strikes += max(1, int(amount))
        if self.tracer is not None:
            self.tracer.event("breaker_strike", pid=FLEET_PID,
                              replica=rep.idx, strikes=rep.strikes,
                              amount=int(amount), state=rep.state)
        limit = 1 if rep.state == "probation" else self.breaker_threshold
        if rep.strikes >= limit:
            self._wedge(rep)

    def _wedge(self, rep: Replica):
        rep.state = "wedged"
        rep.wedges += 1
        rep.wedged_at = self._step_no
        rep.strikes = 0
        self.failovers += 1
        if self.tracer is not None:
            self.tracer.event("breaker_wedge", pid=FLEET_PID,
                              replica=rep.idx, wedges=rep.wedges,
                              step=self._step_no)
        self._drain(rep)

    def _drain(self, rep: Replica):
        """Harvest every fleet request the wedged replica still owes an
        answer for — live (queued/prefilling/running) plus the ones its
        fault burst just failed — cancel them locally (host-side pool
        unwind only; nothing is dispatched to the wedged device) and
        re-enqueue them on healthy replicas as prompt+generated-history
        recomputes. Migration order is fid order: deterministic, FIFO-
        fair. With no healthy replica left the requests stay terminal
        on the wedged engine (the fleet is down; results of already-
        finished requests remain readable)."""
        if rep.transport.remote:
            self._drain_remote(rep)
            return
        eng = rep.engine
        victims = []            # (record, out_tokens harvested)
        for fid in sorted(self._requests):
            rec = self._requests[fid]
            if rec.replica != rep.idx:
                continue
            req = eng._find_request(rec.rid)
            if req is None:
                continue
            if req.state in ("queued", "prefilling", "running"):
                victims.append((rec, list(req.out_tokens)))
                # the local abort is a MIGRATION, not a terminal end:
                # keep the lifetime span open so the adopted
                # continuation on the new replica stays one span
                req.trace_keep_open = True
                try:
                    eng.cancel(rec.rid)
                except Exception:       # noqa: BLE001 — wedged engine:
                    pass                # best-effort local unwind
            elif (req.state == "failed"
                  and rec.rid not in rep.burst_failed_mark):
                victims.append((rec, list(req.out_tokens)))
                if self.tracer is not None:
                    # the burst failure already closed this span; the
                    # migration supersedes it — rescind the end so the
                    # adopted continuation keeps ONE continuous span
                    self.tracer.reopen_request(rec.trace_id)
        if self.tracer is not None:
            self.tracer.event("failover", pid=FLEET_PID,
                              replica=rep.idx, victims=len(victims))
        for rec, toks in victims:
            self._migrate(rec, toks)

    def _drain_remote(self, rep: Replica):
        """The journal-backed drain: a remote replica's
        memory may be GONE (SIGKILL) or unreachable (hang), so the
        harvest reads the Router's own journal — delivered-token
        watermarks updated at collection with exactly-once semantics —
        instead of the engine. Live entries migrate with their
        delivered history (token-identical greedy resume); entries the
        fault burst failed migrate like the in-proc path. Cancels are
        best-effort RPCs, skipped entirely for a dead worker."""
        alive = rep.transport.alive()
        victims = []
        for fid in sorted(self._requests):
            rec = self._requests[fid]
            if rec.replica != rep.idx:
                continue
            je = self._journal.get(fid)
            if je is None:
                continue
            if je.state in _LIVE_STATES:
                victims.append((rec, list(je.delivered)))
                if alive:
                    # migration, not a terminal end: the worker keeps
                    # the span open (migrate_cancel sets
                    # trace_keep_open before the local unwind)
                    try:
                        rep.transport.migrate_cancel(rec.rid)
                    except Exception:   # noqa: BLE001 — best effort
                        pass
            elif (je.state == "failed"
                  and fid not in rep.burst_failed_mark):
                victims.append((rec, list(je.delivered)))
                if self.tracer is not None:
                    # the forwarded burst-failure end already closed
                    # this span; the migration supersedes it (if the
                    # end record never made it over the pipe before
                    # the death, reopen is a harmless no-op)
                    self.tracer.reopen_request(rec.trace_id)
        if self.tracer is not None:
            self.tracer.event("failover", pid=FLEET_PID,
                              replica=rep.idx, victims=len(victims))
        for rec, toks in victims:
            self._migrate(rec, toks)

    def _migrate(self, rec: _FleetRequest, out_tokens: List[int]):
        """Re-enqueue one drained request on the best healthy replica
        (affinity order over prompt ++ history — the history's blocks
        may be cache-hot somewhere). adopt_request bypasses overload
        shedding, so the first candidate accepts; greedy continuation
        is token-identical by the no-sample recompute contract."""
        ctx = (np.concatenate([rec.prompt,
                               np.asarray(out_tokens, np.int32)])
               if out_tokens else rec.prompt)
        order, _ = self._ranked(ctx, rec.sampling,
                                exclude=(rec.replica,))
        for target in order:
            try:
                rid = target.transport.adopt_request(
                    rec.prompt, rec.sampling, out_tokens=out_tokens,
                    t_submit=rec.t_submit, trace_id=rec.trace_id)
            except Exception:   # noqa: BLE001 — a refusing candidate
                # (heterogeneous fleet: adapter not registered there,
                # tighter pool geometry) must not abort the drain: the
                # remaining victims still need their migration, and
                # step()'s never-raises contract covers drains too
                continue
            if self.tracer is not None:
                self.tracer.event(
                    "migrate", trace=rec.trace_id, pid=FLEET_PID,
                    fid=rec.fid, src=rec.replica, dst=target.idx,
                    history=len(out_tokens))
            rec.rid = rid
            rec.replica = target.idx
            rec.migrations += 1
            self.migrated_requests += 1
            je = self._journal.get(rec.fid)
            if je is not None:
                # the adopted request's history IS the harvested
                # tokens: re-anchor the watermark so the new owner's
                # deliveries extend from exactly here
                je.delivered = [int(t) for t in out_tokens]
                je.state = "queued"
                je.error = None
            return
        # no candidate accepted (fleet down / nowhere fits): the
        # request stays terminal on the wedged engine — its record
        # still resolves (result() returns the partial tokens, the
        # state reads aborted/failed) and the refusal is COUNTED so
        # a failovers-vs-victims delta is visible in stats
        self.failed_migrations += 1
        je = self._journal.get(rec.fid)
        if je is not None and je.state in _LIVE_STATES:
            # remote owner: record the terminal verdict in the journal
            # so request()/result() answer from it — the dead/respawned
            # worker can no longer speak for this fid
            je.state = "failed"
            je.error = "migration failed"
        if self.tracer is not None:
            self.tracer.event("migration_failed", trace=rec.trace_id,
                              pid=FLEET_PID, fid=rec.fid,
                              src=rec.replica)
            # the drain suppressed the local abort's span end expecting
            # a continuation that never came — close it here
            self.tracer.end_request(rec.trace_id, "failed",
                                    replica=rec.replica,
                                    error="migration failed")

    def _maybe_probation(self, rep: Replica):
        if (self.cooldown_steps is not None
                and self._step_no - rep.wedged_at
                >= self.cooldown_steps):
            rep.state = "probation"
            rep.strikes = 0
            rep.probation_clean = 0
            if self.tracer is not None:
                self.tracer.event("breaker_probation", pid=FLEET_PID,
                                  replica=rep.idx, step=self._step_no)

    # -- supervisor ------------------------------------------------------------
    def _worker_death(self, rep: Replica, reason: str):
        """A remote replica's PROCESS is gone (pipe EOF / waitpid) or
        beyond trust (heartbeat-silent past the wedge): count the
        exit, wedge + journal-drain it, then respawn if supervised."""
        self.worker_exits += 1
        if self.tracer is not None:
            self.tracer.event("worker_exit", pid=FLEET_PID,
                              replica=rep.idx, reason=reason,
                              step=self._step_no)
        if rep.state != "wedged":
            self._wedge(rep)
        if self.respawn:
            self._respawn(rep)

    def _respawn(self, rep: Replica):
        """Supervisor restart: fresh worker + engine, replayed warmup
        / warmup_programs / seal_programs (the respawned replica must
        serve with a SEALED program set or every dispatch would count
        as an unexpected recompile), then straight onto PROBATION —
        the re-admission ladder, no cooldown (the old process is
        gone; there is nothing to cool down)."""
        t0 = time.perf_counter()
        try:
            rep.transport.respawn()
        except Exception as e:  # noqa: BLE001 — a failed respawn
            # leaves the replica wedged; the supervisor does not loop
            if self.tracer is not None:
                self.tracer.event("worker_respawn_failed",
                                  pid=FLEET_PID, replica=rep.idx,
                                  error=type(e).__name__)
            return
        wall = time.perf_counter() - t0
        self.worker_restarts += 1
        rep.state = "probation"
        rep.strikes = 0
        rep.probation_clean = 0
        rep.exh_mark = 0        # fresh engine: counters restart at 0
        rep.disp_mark = 0
        rep.snap_failed_cnt = 0
        rep.burst_failed_mark = frozenset()
        if self.tracer is not None:
            self.tracer.event("worker_respawn", pid=FLEET_PID,
                              replica=rep.idx, step=self._step_no,
                              wall_s=wall)

    # -- stepping ------------------------------------------------------------
    def step(self) -> bool:
        """One fleet iteration: step every non-wedged replica, read its
        health signals, trip the breaker and drain where needed, and
        revive cooled-down replicas onto probation. Returns True while
        any steppable replica has work. Like ServingEngine.step(), this
        never raises on a replica fault — a dying replica becomes a
        drain, not an exception. Process-transport replicas add two
        pre-step liveness gates (process exit, heartbeat silence) and
        a post-step journal update."""
        self._step_no += 1
        for rep in self.replicas:
            if rep.state == "wedged":
                self._maybe_probation(rep)
                continue
            tr = rep.transport
            if tr.remote:
                if not tr.alive():
                    # process exit (waitpid): immediate wedge + drain
                    # + respawn — no strike accumulation; a dead
                    # process yields no more evidence
                    self._worker_death(rep, "process_exit")
                    continue
                if rep.strikes == 0:
                    rep.burst_failed_mark = self._failed_fids(rep)
                age = tr.heartbeat_age()
                if (self.heartbeat_timeout_s is not None
                        and age is not None
                        and age > self.heartbeat_timeout_s):
                    # heartbeat-silent: strike (not instant wedge —
                    # one missed beat on a loaded host is evidence,
                    # not proof). The step RPC is SKIPPED: a hung
                    # worker would cost the full RPC deadline
                    self.heartbeat_misses += 1
                    if self.tracer is not None:
                        self.tracer.event(
                            "heartbeat_miss", pid=FLEET_PID,
                            replica=rep.idx, age_s=age)
                    self._strike(rep, 1, rep.burst_failed_mark)
                    if rep.state == "wedged" and self.respawn:
                        # wedged on silence: the process is beyond
                        # trust — kill it and respawn fresh
                        try:
                            tr.kill_worker()
                        except Exception:   # noqa: BLE001
                            pass
                        self._worker_death(rep, "heartbeat")
                    continue
            else:
                eng = rep.engine
                # pre-step failed-set snapshot: only consulted if THIS
                # step opens a strike burst (see _strike). The
                # frozenset is rebuilt only when engine.failed moved
                # since the last build — an O(1) check per step
                # instead of an O(finished) scan of _done; mid-burst
                # (strikes > 0) the burst-start snapshot must stand,
                # so no refresh
                if rep.strikes == 0 \
                        and eng.failed != rep.snap_failed_cnt:
                    rep.burst_failed_mark = self._failed_rids(eng)
                    rep.snap_failed_cnt = eng.failed
            prestep_mark = rep.burst_failed_mark
            acks, ridmap = self._acks_for(rep)
            try:
                res = tr.step(acks)
            except WorkerDied:
                self._worker_death(rep, "process_exit")
                continue
            except TransportError:
                # retries exhausted but the process is alive: fault
                # evidence, same ladder as a dispatch exhaustion
                self._strike(rep, 1, prestep_mark)
                continue
            # journal first, health second: the drain a strike may
            # trigger reads the journal, which must reflect THIS
            # step's deliveries (exactly-once by the ack-base check)
            self._apply_deliveries(res.deliveries, ridmap)
            rep.last_load = res.load
            exh = res.dispatch_exhaustions - rep.exh_mark
            rep.exh_mark = res.dispatch_exhaustions
            disp = res.device_dispatches - rep.disp_mark
            rep.disp_mark = res.device_dispatches
            stalled = (self.stall_timeout_s is not None
                       and res.wall > self.stall_timeout_s)
            if res.raised or exh > 0 or stalled:
                self._strike(rep, exh, prestep_mark)
            elif disp > 0:
                # clean step WITH device activity: real evidence of
                # health. Idle steps prove nothing — they neither
                # strike nor forgive (a replica that failed its whole
                # queue and went quiet must not launder its record)
                rep.strikes = 0
                if rep.state == "probation":
                    rep.probation_clean += 1
                    if rep.probation_clean >= self.probation_steps:
                        rep.state = "healthy"
                        if self.tracer is not None:
                            self.tracer.event(
                                "breaker_promote", pid=FLEET_PID,
                                replica=rep.idx, step=self._step_no)
        if self.tracer is not None:
            # fleet counter tracks: per-replica load on the
            # replica's own track, fleet health on the fleet track —
            # the resource timeline next to the request spans
            for rep in self.replicas:
                self.tracer.counter(
                    "load",
                    (rep.last_load if rep.transport.remote
                     else self._load(rep.engine)),
                    pid=rep.idx)
            self.tracer.counter(
                "healthy_replicas",
                sum(1 for rep in self.replicas
                    if rep.state == "healthy"), pid=FLEET_PID)
        return self.has_work

    def run_to_completion(self) -> Dict[int, np.ndarray]:
        while self.step():
            pass
        out = {}
        for fid in list(self._requests):
            try:
                out[fid] = self.result(fid)
            except KeyError:
                pass
        return out

    def warmup(self, prompt_len: Optional[int] = None,
               seal_programs: bool = False):
        """Warm every replica's compiled programs, then reset stats so
        warmup traffic never pollutes the fleet numbers.
        ``seal_programs=True`` additionally grid-warms and SEALS each
        replica's program set (ServingEngine.warmup contract)."""
        for rep in self.replicas:
            if rep.state != "wedged":
                rep.transport.warmup(prompt_len,
                                     seal_programs=seal_programs)
        self.clear_finished()

    def warmup_programs(self, max_width: Optional[int] = None):
        """Grid-compile every replica's reachable program set by
        direct invocation (no scheduler traffic, no PRNG keys — see
        ServingEngine.warmup_programs). On the process transport this
        call (like warmup/seal) is recorded by the transport and
        REPLAYED into a respawned worker, so a supervisor restart
        comes back with the same compiled+sealed program set."""
        for rep in self.replicas:
            if rep.state != "wedged":
                rep.transport.warmup_programs(max_width)

    def seal_programs(self):
        """Seal every healthy replica's program set: any later compile
        counts in that replica's unexpected_recompiles and the fleet
        rollup — the chaos dp leg asserts the sum stays zero. A WEDGED
        replica is skipped exactly like warmup_programs skips it:
        sealing it cold would turn the recovered replica's legitimate
        grid compiles into false retrace verdicts."""
        for rep in self.replicas:
            if rep.state != "wedged":
                rep.transport.seal_programs()

    # -- stats ---------------------------------------------------------------
    def _journal_bytes(self) -> int:
        """Approximate resident size of the failover journal — the
        cost of exactly-once delivery, surfaced so capacity planning
        can see it. Prompt array + 4B/delivered token +
        a fixed per-entry overhead for the dataclass + dict slot."""
        total = 0
        for fid, je in self._journal.items():
            rec = self._requests.get(fid)
            if rec is not None and rec.prompt is not None:
                total += int(getattr(rec.prompt, "nbytes",
                                     4 * len(rec.prompt)))
            total += 4 * len(je.delivered) + 96
        return total

    def stats(self) -> dict:
        """Fleet rollup + per-replica breakdown.

        ``fleet`` carries the routing counters (affinity_hits / spills
        / failovers / migrated_requests / shed_requests — all reset by
        clear_finished), goodput (tokens delivered by successfully
        finished requests, fleet-wide)
        and TRUE fleet ITL percentiles computed over the union of every
        replica's raw inter-token samples (percentiles don't average;
        the per-replica stats() percentiles are reported alongside).
        ``replicas`` is each engine's own stats() plus its health
        record."""
        bundles = [rep.transport.stats_bundle()
                   for rep in self.replicas]
        snaps = [b["snapshot"] for b in bundles]
        itls = Reservoir.merge(
            [(p[0], p[1]) for s in snaps for p in s["itl_parts"]],
            k=ServingEngine.ITL_RESERVOIR_K)
        hit = sum(s["prefix_hit_tokens"] for s in snaps)
        query = sum(s["prefix_query_tokens"] for s in snaps)
        migrated_done = 0
        for fid, rec in self._requests.items():
            if rec.migrations > 0:
                rep = self.replicas[rec.replica]
                if rep.transport.remote:
                    je = self._journal.get(fid)
                    if je is not None and je.state == "done":
                        migrated_done += 1
                    continue
                req = rep.engine._find_request(rec.rid)
                if req is not None and req.state == "done":
                    migrated_done += 1
        fleet = {
            "replicas": self.dp,
            "healthy_replicas": sum(1 for rep in self.replicas
                                    if rep.state == "healthy"),
            "wedged_replicas": sum(1 for rep in self.replicas
                                   if rep.state == "wedged"),
            "routed_requests": self.routed_requests,
            "affinity_hits": self.affinity_hits,
            "affinity_hit_rate": (self.affinity_hits
                                  / self.routed_requests
                                  if self.routed_requests else 0.0),
            "spills": self.spills,
            "failovers": self.failovers,
            "migrated_requests": self.migrated_requests,
            "migrated_done": migrated_done,
            "failed_migrations": self.failed_migrations,
            # FLEET-level refusals only: a per-replica shed that spilled
            # to another replica was served, not shed (the per-replica
            # counts stay visible in the replicas list)
            "shed_requests": self.shed_requests,
            "finished": sum(s["finished"] for s in snaps),
            "generated_tokens": sum(s["generated_tokens"]
                                    for s in snaps),
            "goodput_tokens": sum(s["goodput_tokens"]
                                  for s in snaps),
            "itl_p50_s": (float(np.quantile(itls, 0.50))
                          if itls else None),
            "itl_p99_s": (float(np.quantile(itls, 0.99))
                          if itls else None),
            "preemptions": sum(s["preemptions"] for s in snaps),
            "aborted": sum(s["aborted"] for s in snaps),
            "failed": sum(s["failed"] for s in snaps),
            "retries": sum(s["retries"] for s in snaps),
            "dispatch_exhaustions": sum(s["dispatch_exhaustions"]
                                        for s in snaps),
            "device_dispatches": sum(s["device_dispatches"]
                                     for s in snaps),
            "prefix_cache_hit_rate": hit / query if query else 0.0,
            # -- program observatory -----------------------------------
            # fleet-wide compile ledger: the chaos dp leg asserts the
            # unexpected sum stays zero after sealing
            "program_compiles": sum(s["program_compiles"]
                                    for s in snaps),
            "unexpected_recompiles": sum(s["unexpected_recompiles"]
                                         for s in snaps),
            # -- process fleet ---------------------------------------
            # supervisor + transport health, all reset by
            # clear_finished like every counter family above
            "worker_exits": self.worker_exits,
            "worker_restarts": self.worker_restarts,
            "heartbeat_misses": self.heartbeat_misses,
            "rpc_retries": sum(rep.transport.rpc_retries
                               for rep in self.replicas),
            "journal_requests": len(self._journal),
            "journal_bytes": self._journal_bytes(),
        }
        per = []
        for rep, bundle in zip(self.replicas, bundles):
            st = dict(bundle["stats"])
            st["replica"] = rep.idx
            st["state"] = rep.state
            st["wedges"] = rep.wedges
            st["load"] = (bundle["snapshot"]["load"]
                          if rep.transport.remote
                          else self._load(rep.engine))
            per.append(st)
            if self.tracer is not None and rep.transport.remote \
                    and bundle["stats"]:
                # a worker's engine.stats() published into ITS OWN
                # registry; mirror the numeric view into the parent so
                # trace_report and the gate read one registry
                self.tracer.metrics.publish(
                    "engine" if rep.idx == 0 else f"engine{rep.idx}",
                    bundle["stats"])
        if self._slo_policies or any("slo" in st for st in per):
            # per-replica SLO headroom rollup — the input SLO-aware
            # routing needs: route a deadline class to the
            # replica with the most headroom for its policy. min
            # headroom per policy says how close the FLEET is to
            # paging; a wedged replica reports no headroom entry
            headroom: Dict[str, Dict[str, float]] = {}
            for rep, st in zip(self.replicas, per):
                slo = st.get("slo")
                if not slo:
                    continue
                for pname, pol in slo["policies"].items():
                    headroom.setdefault(pname, {})[str(rep.idx)] = \
                        pol["headroom"]
            fleet["slo"] = {
                "headroom": headroom,
                "min_headroom": {
                    pname: min(vals.values())
                    for pname, vals in headroom.items() if vals}}
        if self.tracer is not None:
            # the unified registry mirrors the fleet rollup under
            # "fleet.*"; each engine's stats() call above published its
            # own view under its per-replica namespace ("engine" for
            # replica 0, "engine1"... beyond — no overwriting)
            self.tracer.metrics.publish("fleet", fleet)
            for pname, vals in fleet.get("slo", {}).get(
                    "headroom", {}).items():
                for ridx, h in vals.items():
                    self.tracer.metrics.set_gauge(
                        f"fleet.slo.{pname}.r{ridx}.headroom",
                        float(h))
        return {"fleet": fleet, "replicas": per}

    def clear_finished(self):
        """Fleet-wide counter reset (the clear_finished contract every
        counter family honors): every replica's clear_finished plus the
        routing/failover counters; terminal fleet records are dropped
        with their engine records (live requests keep their mapping)."""
        for rep in self.replicas:
            if rep.transport.remote:
                try:
                    rep.transport.clear_finished()
                except TransportError:
                    pass            # dead worker: nothing to clear
                # the worker's clear_finished zeroed the engine
                # counters the watermarks track, so the parent-side
                # watermarks follow to zero
                rep.exh_mark = 0
                rep.disp_mark = 0
                rep.snap_failed_cnt = 0
                rep.transport.rpc_retries = 0
            else:
                rep.engine.clear_finished()
                rep.exh_mark = rep.engine.dispatch_exhaustions
                rep.disp_mark = rep.engine.device_dispatches
                rep.snap_failed_cnt = rep.engine.failed
            rep.burst_failed_mark = frozenset()
        self.routed_requests = 0
        self.affinity_hits = 0
        self.spills = 0
        self.failovers = 0
        self.migrated_requests = 0
        self.failed_migrations = 0
        self.shed_requests = 0
        self.worker_exits = 0
        self.worker_restarts = 0
        self.heartbeat_misses = 0
        live = {}
        for fid, rec in self._requests.items():
            rep = self.replicas[rec.replica]
            if rep.transport.remote:
                je = self._journal.get(fid)
                if je is not None and je.state in _LIVE_STATES:
                    live[fid] = rec
            elif rep.engine._find_request(rec.rid) is not None:
                live[fid] = rec
        self._requests = live
        # terminal journal entries go with their fleet records: the
        # journal is a FAILOVER ledger, not an archive — exactly-once
        # needs it only while the request can still produce tokens
        self._journal = {fid: je for fid, je in self._journal.items()
                         if fid in live}

    # -- shutdown --------------------------------------------------------------
    def close(self):
        """Tear the fleet down: close every transport (in-proc engines
        settle their in-flight requests; process workers get a close
        RPC then join, escalating to kill on a hung worker). Safe to
        call twice, safe to call on a half-dead fleet — shutdown is
        the one path that must never raise."""
        if self._closed:
            return
        self._closed = True
        for rep in self.replicas:
            try:
                rep.transport.close()
            except Exception:       # noqa: BLE001 — best-effort
                pass

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
