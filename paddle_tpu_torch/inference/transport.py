"""Replica transports: how the fleet Router drives a ServingEngine.
Counterpart: ``paddle_tpu/inference/transport.py``.

- ``InProcTransport``: the engine lives in the Router's process and every
  method delegates to it.
- ``ProcTransport``: the engine lives in a worker process started with
  ``multiprocessing``'s spawn context (never fork: the parent holds a
  CUDA context), driving a command loop over a duplex pipe. One RPC is
  ``(mid, verb, payload)`` -> ``(mid, status, result)``; a reader thread
  routes replies by message id, so heartbeats and replies share the
  pipe.

Exactly-once RPC: the worker keeps a reply cache keyed on the message id,
and a retry (timeout, dropped reply) sends the same id, so the worker
answers from the cache without running the verb again; a ``step`` retried
never advances the engine twice. A ``step`` carries ``{rid: delivered}``
acks and its reply only the tokens past each ack, with the request's
state, so the Router's journal grows exactly once however often a reply
crosses the pipe.

Liveness is two signals: a heartbeat thread in the worker sends
``("hb", t)`` every ``heartbeat_interval_s`` (``hb_pause`` silences it
while the command loop still answers), and the process's exit code; the
reader thread turns pipe EOF into ``WorkerDied`` on every pending RPC at
once, so a SIGKILLed worker fails fast.

Neither the worker's heartbeat thread nor the parent's reader thread
touches ``torch.cuda``: a CUDA call from another thread while the engine
captures a graph (capture mode "global") would spoil the capture.

The worker builds its engine on its own device from a ``WorkerSpec``: a
model travels as its config and its parameters as CPU numpy arrays, never
as CUDA tensors; or a module-level factory builds the engine there. A
parent on a card loads the kernel library before it spawns, so workers
find it built (the build is also locked across processes).

Telemetry forwarding: a traced worker owns a Tracer whose trace ids start
at a base disjoint per (replica, generation); ``step`` and
``stats_bundle`` replies carry the records appended since the last drain
and the parent ingests them. ``perf_counter`` is CLOCK_MONOTONIC on Linux,
shared across processes; a ping-measured offset is applied only if the
clocks visibly disagree.

Chaos hooks, as in ``utils.chaos``: ``inject_kill()`` asks the worker to
SIGKILL itself, and a parent-side ``fault_hook("send"/"recv", verb)``
lets a seeded ChaosMonkey drop RPCs, so the retry path runs
deterministically.
"""
from __future__ import annotations

import itertools
import os
import signal
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "TransportError", "RPCTimeout", "WorkerDied", "RemoteEngineError",
    "ReplicaTransport", "InProcTransport", "ProcTransport", "WorkerSpec",
    "RequestView", "StepResult", "collect_deliveries", "model_state",
    "engine_from_model",
]


class TransportError(RuntimeError):
    """Base of every transport-level failure (timeout, torn pipe,
    injected drop). Application errors raised BY the engine cross the
    wire as typed replies and re-raise as their own types — they are
    never TransportError and are never retried."""


class RPCTimeout(TransportError):
    """An RPC exceeded its per-call deadline."""


class WorkerDied(TransportError):
    """The worker process exited (pipe EOF / waitpid) — retrying is
    pointless; the Router turns this into a wedge + respawn."""


@dataclass
class RequestView:
    """Cross-process stand-in for serving.Request: the fields the
    Router/harness read (state machine position, generated tokens,
    fault reason). Duck-types the live object for remote replicas."""
    req_id: int
    state: str
    out_tokens: List[int]
    error: Optional[str] = None
    trace_id: Optional[int] = None


@dataclass
class StepResult:
    """One engine step's health + delivery report. Counters are
    CUMULATIVE engine counters (the Router keeps watermarks);
    ``deliveries`` is one entry per acked request: tokens beyond the
    ack watermark plus the post-step state."""
    wall: float
    raised: bool
    dispatch_exhaustions: int
    device_dispatches: int
    failed: int
    deliveries: List[dict]
    load: int
    has_work: bool


# -- shared host-side readers (Router-process AND worker-process) ------------

def _engine_load(eng) -> int:
    """Host-side load proxy: live requests (queued + slotted)."""
    return len(eng._queue) + sum(1 for s in eng._slots if s is not None)


def _engine_coverage(eng, prompt, salt) -> int:
    """Cached chain-hash coverage of ``prompt``, in tokens: the prefix
    index walk, host side only."""
    if not eng.prefix_caching:
        return 0
    cache = eng.dec.cache
    return len(cache.match_prefix(prompt, salt)) * cache.block_size


def collect_deliveries(eng, acks: Dict[int, int]) -> List[dict]:
    """Per acked request: tokens beyond the ack watermark + state.
    Pure host reads (no device traffic); ``base`` echoes the ack so the
    Router's journal extension is idempotent under RPC retry."""
    out = []
    for rid, base in acks.items():
        base = int(base)
        req = eng._find_request(rid)
        if req is None:
            out.append({"rid": int(rid), "base": base, "tokens": [],
                        "state": "gone", "error": None})
            continue
        out.append({"rid": int(rid), "base": base,
                    "tokens": [int(t) for t in req.out_tokens[base:]],
                    "state": req.state, "error": req.error})
    return out


def _engine_snapshot(eng) -> dict:
    """The attribute reads Router.stats() aggregates across replicas —
    gathered into one picklable dict so the remote path ships it in a
    single RPC and the in-proc path reads the same shape."""
    cache = eng.dec.cache
    live = [x for r in eng._slots if r is not None for x in r.itls]
    return {
        "itl_parts": [(list(eng._itl_res.samples), eng._itl_res.n),
                      (live, len(live))],
        "goodput_tokens": sum(len(r.out_tokens)
                              for r in eng._done.values()
                              if r.state == "done"),
        "finished": sum(1 for r in eng._done.values()
                        if r.state == "done"),
        "prefix_hit_tokens": cache.prefix_hit_tokens,
        "prefix_query_tokens": cache.prefix_query_tokens,
        "generated_tokens": eng.generated_tokens,
        "preemptions": eng.preemptions,
        "aborted": eng.aborted,
        "failed": eng.failed,
        "retries": eng.retries,
        "dispatch_exhaustions": eng.dispatch_exhaustions,
        "device_dispatches": eng.device_dispatches,
        "program_compiles": eng.program_compiles,
        "unexpected_recompiles": eng.unexpected_recompiles,
        "load": _engine_load(eng),
    }


class ReplicaTransport:
    """The verbs the Router needs from a replica. ``remote`` is the
    single branch point the Router consults for the places where the
    two transports genuinely differ (journal-based drain, view
    fallback, death detection) — everything else goes through these
    methods on both."""

    remote = False
    rpc_retries = 0          # transient-RPC retries taken (remote only)

    # request surface
    def add_request(self, prompt, sp) -> Tuple[int, Optional[int]]:
        raise NotImplementedError

    def adopt_request(self, prompt, sp, out_tokens, t_submit,
                      trace_id) -> int:
        raise NotImplementedError

    def cancel(self, rid: int) -> bool:
        raise NotImplementedError

    def result(self, rid: int) -> np.ndarray:
        raise NotImplementedError

    def view(self, rid: int):
        raise NotImplementedError

    # routing inputs
    def match_coverage(self, prompt, salt) -> int:
        raise NotImplementedError

    def load(self) -> int:
        raise NotImplementedError

    def has_work(self) -> bool:
        raise NotImplementedError

    # stepping / health
    def step(self, acks: Dict[int, int]) -> StepResult:
        raise NotImplementedError

    def alive(self) -> bool:
        return True

    def heartbeat_age(self) -> Optional[float]:
        return None

    # lifecycle
    def warmup(self, prompt_len=None, seal_programs=False):
        raise NotImplementedError

    def warmup_programs(self, max_width=None):
        raise NotImplementedError

    def seal_programs(self):
        raise NotImplementedError

    def stats_bundle(self) -> dict:
        raise NotImplementedError

    def clear_finished(self):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class InProcTransport(ReplicaTransport):
    """The engine in the Router's own process: every method delegates to
    it directly."""

    remote = False

    def __init__(self, engine):
        self.engine = engine

    def add_request(self, prompt, sp):
        rid = self.engine.add_request(prompt, sp)
        req = self.engine._find_request(rid)
        return rid, (req.trace_id if req is not None else None)

    def adopt_request(self, prompt, sp, out_tokens, t_submit, trace_id):
        return self.engine.adopt_request(
            prompt, sp, out_tokens=out_tokens, t_submit=t_submit,
            trace_id=trace_id)

    def cancel(self, rid):
        return self.engine.cancel(rid)

    def result(self, rid):
        return self.engine.result(rid)

    def view(self, rid):
        return self.engine._find_request(rid)

    def match_coverage(self, prompt, salt):
        return _engine_coverage(self.engine, prompt, salt)

    def load(self):
        return _engine_load(self.engine)

    def has_work(self):
        return self.engine.has_work

    def step(self, acks):
        eng = self.engine
        t0 = time.perf_counter()
        raised = False
        try:
            eng.step()
        except Exception:       # noqa: BLE001 — step() never raises by
            raised = True       # contract; a wedge IS the never case
        wall = time.perf_counter() - t0
        return StepResult(
            wall=wall, raised=raised,
            dispatch_exhaustions=eng.dispatch_exhaustions,
            device_dispatches=eng.device_dispatches,
            failed=eng.failed,
            deliveries=collect_deliveries(eng, acks),
            load=_engine_load(eng), has_work=eng.has_work)

    def warmup(self, prompt_len=None, seal_programs=False):
        self.engine.warmup(prompt_len, seal_programs=seal_programs)

    def warmup_programs(self, max_width=None):
        self.engine.warmup_programs(max_width)

    def seal_programs(self):
        self.engine.seal_programs()

    def stats_bundle(self):
        return {"snapshot": _engine_snapshot(self.engine),
                "stats": self.engine.stats()}

    def clear_finished(self):
        self.engine.clear_finished()

    def close(self):
        self.engine.close()


# -- process transport --------------------------------------------------------

def engine_from_model(model, tp: int = 1, devices=None, **kw):
    """A replica's engine from a model: ``ServingEngine(model, ...)`` for
    a ``LlamaForCausalLM``; a ``GPTForCausalLM`` is served through the
    decoder ``decoder_from_model`` builds (the pool arguments
    ``num_blocks``, ``block_size``, ``weight_dtype``, ``kv_quant``, and
    ``device`` and ``tp_comm``, go to it), as the engine serves that
    family only through a prebuilt decoder."""
    from ..models.gpt import GPTForCausalLM
    from .serving import ServingEngine, decoder_from_model
    if not isinstance(model, GPTForCausalLM):
        return ServingEngine(model, tp=tp, devices=devices, **kw)
    dec_kw = {k: kw.pop(k) for k in ("num_blocks", "block_size",
                                     "weight_dtype", "kv_quant", "device",
                                     "tp_comm") if k in kw}
    return ServingEngine(decoder_from_model(model, tp=tp, devices=devices,
                                            **dec_kw), tp=tp, **kw)


def model_state(model) -> Dict[str, tuple]:
    """A ``LlamaForCausalLM``'s or ``GPTForCausalLM``'s parameters as
    CPU numpy arrays, fit to cross a pipe: ``{name: (array, dtype
    name)}``, a bfloat16 tensor as its 16-bit integer view (numpy has
    no bfloat16), so the weights travel bit for bit."""
    import torch
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[name] = (t.view(torch.int16).numpy().copy(), "bfloat16")
        else:
            out[name] = (t.numpy().copy(), str(t.dtype).replace(
                "torch.", ""))
    return out


def _load_model_state(model, state: Dict[str, tuple]):
    import torch
    params = dict(model.named_parameters())
    if set(params) != set(state):
        raise ValueError(f"model state names differ: "
                         f"{sorted(set(params) ^ set(state))}")
    with torch.no_grad():
        for name, p in params.items():
            arr, dtype = state[name]
            t = torch.from_numpy(np.array(arr))
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            p.copy_(t.to(p.device))


@dataclass
class WorkerSpec:
    """Everything a spawned worker needs to build its engine; picklable.
    The default path carries the model as its config and ``model_state``
    (CPU numpy arrays, never CUDA tensors) and the worker builds the
    config's model (``LlamaForCausalLM`` or ``GPTForCausalLM``) on the
    engine's device (``engine_kwargs["device"]``; None: cuda) before
    ``engine_from_model``; the
    factory path carries a module-level callable ``f(replica_idx,
    devices)`` returning the engine. At tp > 1 the worker computes its
    own row of ``SpecLayout.fleet_device_slices(dp, tp, devices)``
    (``devices`` as strings; None: the worker's visible cards). ``torch_threads`` sets the worker's
    CPU threads when given."""
    config: Any = None
    state: Optional[Dict[str, tuple]] = None
    factory: Optional[Callable] = None
    dp: int = 1
    tp: int = 1
    devices: Optional[list] = None
    engine_kwargs: Dict[str, Any] = field(default_factory=dict)
    slo_policies: tuple = ()
    traced: bool = False
    torch_threads: Optional[int] = None


def _build_worker_engine(spec: WorkerSpec, replica_id: int):
    devices = None
    if spec.tp > 1:
        from ..distributed.spec_layout import SpecLayout
        devices = SpecLayout().fleet_device_slices(
            spec.dp, spec.tp, spec.devices)[replica_id]
    if spec.factory is not None:
        return spec.factory(replica_id, devices)
    from ..models.gpt import GPTConfig, GPTForCausalLM
    from ..models.llama import LlamaForCausalLM
    kw = dict(spec.engine_kwargs)
    cls = GPTForCausalLM if isinstance(spec.config, GPTConfig) \
        else LlamaForCausalLM
    model = cls(spec.config, device=kw.get("device"))
    _load_model_state(model, spec.state)
    if spec.slo_policies:
        from ..utils.telemetry import SLOMonitor
        kw["slo"] = SLOMonitor(list(spec.slo_policies))
    return engine_from_model(model, tp=spec.tp, devices=devices, **kw)


def _cuda_spec(spec: WorkerSpec) -> bool:
    """Whether a worker of ``spec`` may serve on the card (a factory's
    device is not known here: assume it may)."""
    import torch
    if not torch.cuda.is_available():
        return False
    if spec.factory is not None:
        return True
    dev = spec.engine_kwargs.get("device")
    return dev is None or torch.device(dev).type == "cuda"


# bound on the worker's exactly-once reply cache: must cover every
# message id a retry can still reference (retries are per-call and
# bounded, so a handful suffices; 64 is paranoid headroom)
_REPLY_CACHE = 64


def _worker_main(conn, spec: WorkerSpec, replica_id: int,
                 hb_interval: float, id_base: int):
    """Worker process entry: build the engine, start the heartbeat
    thread, then serve the command loop until ``close`` or pipe EOF.
    Runs in the spawned child, so it stays module level."""
    send_lock = threading.Lock()
    stop = threading.Event()

    def _send(msg):
        with send_lock:
            try:
                conn.send(msg)
            except Exception:   # noqa: BLE001 — parent went away
                stop.set()

    tracer = None
    try:
        if spec.torch_threads:
            import torch
            torch.set_num_threads(int(spec.torch_threads))
        eng = _build_worker_engine(spec, replica_id)
        if spec.traced:
            from ..utils.telemetry import Tracer
            tracer = Tracer(id_base=id_base)
            eng.set_telemetry(tracer, replica_id=replica_id)
    except Exception as e:      # noqa: BLE001 -- report, don't hang
        _send(("ready", {"error": f"{type(e).__name__}: {e}"}))
        return

    hb_state = {"pause_until": 0.0}

    def _hb_loop():
        # the pipe and the clock only: never torch.cuda (see module doc)
        while not stop.wait(hb_interval):
            if time.perf_counter() >= hb_state["pause_until"]:
                _send(("hb", time.perf_counter()))

    threading.Thread(target=_hb_loop, daemon=True).start()
    _send(("ready", {"pid": os.getpid()}))

    replies: OrderedDict = OrderedDict()
    tel_mark = 0
    monkey = None

    def _drain_tel(res: dict):
        nonlocal tel_mark
        if tracer is not None:
            recs, tel_mark = tracer.drain_since(tel_mark)
            res["tel"] = recs
        return res

    while not stop.is_set():
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if not (isinstance(msg, tuple) and msg and msg[0] == "cmd"):
            continue
        _, mid, verb, payload = msg
        if mid in replies:
            # exactly once: a retried mid gets the cached reply and the
            # verb does not run again
            _send(replies[mid])
            continue
        if verb == "chaos_kill":
            # hard death, fire-and-forget: no reply ever
            if monkey is not None:
                monkey.kill()
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            if verb == "ping":
                result = time.perf_counter()
            elif verb == "add_request":
                rid = eng.add_request(payload["prompt"], payload["sp"])
                req = eng._find_request(rid)
                result = (rid, (req.trace_id if req is not None
                                else None))
            elif verb == "adopt_request":
                result = eng.adopt_request(
                    payload["prompt"], payload["sp"],
                    out_tokens=payload["out_tokens"],
                    t_submit=payload["t_submit"],
                    trace_id=payload["trace_id"])
            elif verb == "step":
                t0 = time.perf_counter()
                raised = False
                try:
                    eng.step()
                except Exception:   # noqa: BLE001 -- never, by contract
                    raised = True
                result = _drain_tel({
                    "wall": time.perf_counter() - t0, "raised": raised,
                    "dispatch_exhaustions": eng.dispatch_exhaustions,
                    "device_dispatches": eng.device_dispatches,
                    "failed": eng.failed,
                    "deliveries": collect_deliveries(
                        eng, payload["acks"]),
                    "load": _engine_load(eng),
                    "has_work": eng.has_work})
            elif verb == "cancel":
                result = eng.cancel(payload)
            elif verb == "migrate_cancel":
                req = eng._find_request(payload)
                result = False
                if req is not None and req.state in (
                        "queued", "prefilling", "running"):
                    # a migration, not an end: the span stays open
                    req.trace_keep_open = True
                    try:
                        result = eng.cancel(payload)
                    except Exception:   # noqa: BLE001 — best effort
                        result = False
            elif verb == "result":
                result = eng.result(payload)
            elif verb == "view":
                req = eng._find_request(payload)
                result = None if req is None else {
                    "req_id": req.req_id, "state": req.state,
                    "out_tokens": [int(t) for t in req.out_tokens],
                    "error": req.error, "trace_id": req.trace_id}
            elif verb == "match_coverage":
                result = _engine_coverage(
                    eng, payload["prompt"], payload["salt"])
            elif verb == "load":
                result = _engine_load(eng)
            elif verb == "has_work":
                result = eng.has_work
            elif verb == "warmup":
                eng.warmup(payload["prompt_len"],
                           seal_programs=payload["seal"])
                result = None
            elif verb == "warmup_programs":
                eng.warmup_programs(payload)
                result = None
            elif verb == "seal_programs":
                eng.seal_programs()
                result = None
            elif verb == "stats_bundle":
                result = _drain_tel({
                    "snapshot": _engine_snapshot(eng),
                    "stats": eng.stats()})
            elif verb == "clear_finished":
                eng.clear_finished()
                result = None
            elif verb == "debug_check":
                eng.dec.cache.debug_check()
                if eng.lora is not None:
                    eng._debug_lora_check()
                result = True
            elif verb == "chaos_attach":
                from ..utils.chaos import ChaosMonkey
                monkey = ChaosMonkey(**payload).attach(eng)
                result = None
            elif verb == "chaos_counts":
                result = dict(monkey.counts) if monkey is not None \
                    else {}
            elif verb == "chaos_wedge":
                if monkey is not None:
                    monkey.wedge()
                result = None
            elif verb == "hb_pause":
                hb_state["pause_until"] = time.perf_counter() \
                    + float(payload)
                result = None
            elif verb == "close":
                _send(("reply", mid, "ok", None))
                break
            else:
                raise ValueError(f"unknown transport verb {verb!r}")
            reply = ("reply", mid, "ok", result)
        except Exception as e:  # noqa: BLE001 -- typed across the wire
            reply = ("reply", mid, "err",
                     (type(e).__name__, str(e)))
        replies[mid] = reply
        while len(replies) > _REPLY_CACHE:
            replies.popitem(last=False)
        _send(reply)
    stop.set()
    try:
        eng.close()
    except Exception:           # noqa: BLE001 -- exiting anyway
        pass


class _Waiter:
    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result = None


# engine exceptions that cross the wire by type (the Router's spill,
# validation and cancel paths catch these); anything else re-raises as
# RemoteEngineError, a TransportError
def _map_remote_error(etype: str, emsg: str) -> Exception:
    if etype == "EngineOverloaded":
        from .serving import EngineOverloaded
        return EngineOverloaded(emsg)
    if etype == "KeyError":
        return KeyError(emsg)
    if etype == "ValueError":
        return ValueError(emsg)
    if etype == "KVCacheExhausted":
        from ..ops.paged_attention import KVCacheExhausted
        return KVCacheExhausted(emsg)
    return RemoteEngineError(f"{etype}: {emsg}")


class RemoteEngineError(TransportError):
    """An unmapped exception raised by the remote engine."""


class ProcTransport(ReplicaTransport):
    """One replica engine in a spawned worker process.

    RPCs ride a duplex pipe with per-call deadlines and bounded retry
    with exponential backoff (``retry_backoff_s * 2**(attempt-1)``, as
    the engine's ``_device_call``); the worker's reply cache makes every
    retry exactly-once. ``fault_hook(stage, verb)`` (a seeded
    ``ChaosMonkey.transport_fault``) may raise before the send or after
    the receive, modelling dropped RPCs deterministically."""

    remote = True

    # verbs that may compile program grids: give them a generous floor
    _LONG_VERBS = ("warmup", "warmup_programs", "seal_programs")

    def __init__(self, spec: WorkerSpec, *, replica_id: int = 0,
                 tracer=None, rpc_timeout_s: float = 120.0,
                 rpc_retries: int = 2, retry_backoff_s: float = 0.05,
                 heartbeat_interval_s: float = 0.25,
                 spawn_timeout_s: float = 300.0,
                 fault_hook=None):
        self.spec = spec
        self.replica_id = int(replica_id)
        self.tracer = tracer
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.max_rpc_retries = max(0, int(rpc_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.fault_hook = fault_hook
        self.rpc_retries = 0
        self.generation = 0
        # lifecycle calls replayed on respawn, in order (a fresh
        # engine must re-warm and re-seal or every post-respawn
        # dispatch compiles — and counts as an unexpected recompile)
        self._warm_calls: List[Tuple[str, Any]] = []
        self._chaos_cfg: Optional[dict] = None
        self._last_has_work = False
        self._last_bundle: Optional[dict] = None
        self._closed = False
        self._spawn()

    # -- lifecycle -----------------------------------------------------------
    def _spawn(self):
        import multiprocessing as mp
        if _cuda_spec(self.spec):
            # build (or find) the kernel library here, before any worker
            # starts, so the workers load it instead of compiling it
            from ..ops.cuda import _build
            _build.load_library()
        # spawn, never fork: the parent holds a CUDA context
        ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        self.generation += 1
        # trace-id ranges disjoint per (replica, generation): a merged
        # export never sees one id twice across processes or respawns
        id_base = ((self.replica_id + 1) * 1_000_000_000
                   + (self.generation - 1) * 50_000_000)
        proc = ctx.Process(
            target=_worker_main,
            args=(child_conn, self.spec, self.replica_id,
                  self.heartbeat_interval_s, id_base),
            daemon=True,
            name=f"paddle-torch-replica{self.replica_id}"
                 f"-g{self.generation}")
        proc.start()
        child_conn.close()
        self._conn = parent_conn
        self._proc = proc
        self._dead = False
        self._closed = False
        self._pending: Dict[int, _Waiter] = {}
        self._plock = threading.Lock()
        self._send_lock = threading.Lock()
        self._mids = itertools.count(1)
        self._last_hb = time.perf_counter()
        self._ready = threading.Event()
        self._ready_info: dict = {}
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"transport-reader-r{self.replica_id}")
        self._reader.start()
        if not self._ready.wait(self.spawn_timeout_s) or self._dead:
            self._teardown(kill=True)
            raise TransportError(
                f"replica {self.replica_id} worker failed to start "
                f"within {self.spawn_timeout_s}s")
        if self._ready_info.get("error"):
            self._teardown(kill=True)
            raise TransportError(
                f"replica {self.replica_id} worker engine build "
                f"failed: {self._ready_info['error']}")
        # clock handshake: perf_counter is CLOCK_MONOTONIC on Linux,
        # shared across processes; a measured offset is applied only if
        # the clocks visibly disagree
        t0 = time.perf_counter()
        tw = self._rpc("ping")
        t1 = time.perf_counter()
        off = (t0 + t1) / 2.0 - tw
        self._ts_offset = off if abs(off) > 0.05 else 0.0

    def _read_loop(self):
        # the pipe and the clock only: never torch.cuda (see module doc)
        conn = self._conn
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            kind = msg[0]
            if kind == "hb":
                self._last_hb = time.perf_counter()
            elif kind == "ready":
                self._ready_info = msg[1]
                self._ready.set()
            elif kind == "reply":
                _, mid, status, payload = msg
                with self._plock:
                    w = self._pending.get(mid)
                if w is not None:
                    w.result = (status, payload)
                    w.event.set()
        # pipe EOF: the worker died; fail every pending RPC now (a
        # SIGKILLed worker must not cost an RPC deadline)
        self._dead = True
        with self._plock:
            waiters = list(self._pending.values())
        for w in waiters:
            w.result = ("died", None)
            w.event.set()
        self._ready.set()

    def respawn(self):
        """Supervisor restart: tear the dead worker down, spawn a
        fresh one and replay the recorded lifecycle calls (warmup /
        warmup_programs / seal_programs, then the chaos config) so the
        respawned engine serves with a warm, SEALED program set."""
        self._teardown(kill=True)
        self._spawn()
        for verb, payload in list(self._warm_calls):
            self._rpc(verb, payload,
                      timeout=max(600.0, self.rpc_timeout_s))
        if self._chaos_cfg is not None:
            self._rpc("chaos_attach", self._chaos_cfg)
        self._last_has_work = False

    def _teardown(self, kill: bool):
        proc = getattr(self, "_proc", None)
        if proc is None:
            return
        if not kill and not self._dead and proc.is_alive():
            try:
                self._rpc("close", timeout=30.0, retries=0)
            except Exception:   # noqa: BLE001 — escalate below
                pass
        self._dead = True
        try:
            self._conn.close()
        except Exception:       # noqa: BLE001
            pass
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5.0)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=5.0)
        reader = getattr(self, "_reader", None)
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=5.0)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._teardown(kill=False)

    # -- liveness ------------------------------------------------------------
    def alive(self) -> bool:
        return (not self._dead and self._proc.is_alive())

    def heartbeat_age(self) -> Optional[float]:
        return time.perf_counter() - self._last_hb

    def kill_worker(self):
        """Parent-side SIGKILL (deterministic test hook — the worker
        dies at a point the TEST chooses, not the seeded schedule)."""
        if self._proc.is_alive():
            os.kill(self._proc.pid, signal.SIGKILL)
        self._proc.join(timeout=10.0)

    def inject_kill(self):
        """Ask the worker to SIGKILL ITSELF (ChaosMonkey.kill) — fire
        and forget: no reply will ever come."""
        try:
            with self._send_lock:
                self._conn.send(("cmd", next(self._mids),
                                 "chaos_kill", None))
        except Exception:       # noqa: BLE001 — already dying is fine
            pass

    def hb_pause(self, seconds: float):
        """Pause the worker's heartbeat thread (liveness test hook:
        the main loop keeps answering while the heartbeat goes quiet —
        only a TRUE heartbeat clock can detect this)."""
        self._rpc("hb_pause", float(seconds))

    # -- RPC core ------------------------------------------------------------
    def _verb_timeout(self, verb: str, timeout: Optional[float]):
        if timeout is not None:
            return timeout
        if verb in self._LONG_VERBS:
            return max(600.0, self.rpc_timeout_s)
        return self.rpc_timeout_s

    def _rpc(self, verb: str, payload=None, timeout: Optional[float]
             = None, retries: Optional[int] = None):
        timeout = self._verb_timeout(verb, timeout)
        retries = self.max_rpc_retries if retries is None else retries
        mid = next(self._mids)      # SAME mid across retries: the
        last = None                 # worker's reply cache dedupes
        for attempt in range(retries + 1):
            if attempt:
                self.rpc_retries += 1
                if self.retry_backoff_s > 0:
                    time.sleep(self.retry_backoff_s
                               * (2 ** (attempt - 1)))
            try:
                return self._rpc_once(mid, verb, payload, timeout)
            except WorkerDied:
                raise
            except TransportError as e:
                last = e
            except Exception as e:      # noqa: BLE001 — only the
                # chaos hook's injected drops are retryable; any other
                # exception is a programming error and must surface
                if type(e).__name__ != "InjectedTransportError":
                    raise
                last = e
        raise TransportError(
            f"replica {self.replica_id} rpc {verb!r} failed after "
            f"{retries + 1} attempt(s): {last}") from last

    def _rpc_once(self, mid, verb, payload, timeout):
        if self._dead:
            raise WorkerDied(
                f"replica {self.replica_id} worker is dead")
        hook = self.fault_hook
        if hook is not None:
            hook("send", verb)  # may raise (injected request drop)
        w = _Waiter()
        with self._plock:
            self._pending[mid] = w
        try:
            try:
                with self._send_lock:
                    self._conn.send(("cmd", mid, verb, payload))
            except (OSError, ValueError, BrokenPipeError) as e:
                if self._dead or not self._proc.is_alive():
                    raise WorkerDied(
                        f"replica {self.replica_id} worker died "
                        f"mid-send: {e}") from e
                raise TransportError(f"send failed: {e}") from e
            if not w.event.wait(timeout):
                raise RPCTimeout(
                    f"replica {self.replica_id} rpc {verb!r} timed "
                    f"out after {timeout}s")
        finally:
            with self._plock:
                self._pending.pop(mid, None)
        status, out = w.result
        if status == "died":
            raise WorkerDied(
                f"replica {self.replica_id} worker died during "
                f"{verb!r}")
        if hook is not None:
            hook("recv", verb)  # may raise (injected response drop —
            #                     the retry re-asks; the reply cache
            #                     answers without re-executing)
        if status == "err":
            raise _map_remote_error(*out)
        return out

    # -- request surface -----------------------------------------------------
    def add_request(self, prompt, sp):
        rid, tid = self._rpc("add_request",
                             {"prompt": prompt, "sp": sp})
        self._last_has_work = True
        return rid, tid

    def adopt_request(self, prompt, sp, out_tokens, t_submit,
                      trace_id):
        rid = self._rpc("adopt_request", {
            "prompt": prompt, "sp": sp,
            "out_tokens": list(out_tokens), "t_submit": t_submit,
            "trace_id": trace_id})
        self._last_has_work = True
        return rid

    def cancel(self, rid):
        return self._rpc("cancel", rid)

    def migrate_cancel(self, rid):
        return self._rpc("migrate_cancel", rid)

    def result(self, rid):
        return np.asarray(self._rpc("result", rid), np.int32)

    def view(self, rid):
        v = self._rpc("view", rid)
        return None if v is None else RequestView(**v)

    # -- routing inputs ------------------------------------------------------
    def match_coverage(self, prompt, salt):
        return self._rpc("match_coverage",
                         {"prompt": prompt, "salt": salt})

    def load(self):
        return self._rpc("load")

    def has_work(self):
        # cached from the last step reply (kept True by admissions):
        # an extra idle step is harmless; an RPC per has_work is not
        return self._last_has_work

    # -- stepping ------------------------------------------------------------
    def step(self, acks):
        res = self._rpc("step", {"acks": dict(acks)})
        if self.tracer is not None and res.get("tel"):
            self.tracer.ingest(res["tel"], ts_offset=self._ts_offset)
        self._last_has_work = bool(res["has_work"])
        return StepResult(
            wall=res["wall"], raised=res["raised"],
            dispatch_exhaustions=res["dispatch_exhaustions"],
            device_dispatches=res["device_dispatches"],
            failed=res["failed"], deliveries=res["deliveries"],
            load=res["load"], has_work=res["has_work"])

    # -- lifecycle verbs (recorded for respawn replay) -----------------------
    def warmup(self, prompt_len=None, seal_programs=False):
        payload = {"prompt_len": prompt_len, "seal": bool(seal_programs)}
        self._warm_calls.append(("warmup", payload))
        self._rpc("warmup", payload)

    def warmup_programs(self, max_width=None):
        self._warm_calls.append(("warmup_programs", max_width))
        self._rpc("warmup_programs", max_width)

    def seal_programs(self):
        self._warm_calls.append(("seal_programs", None))
        self._rpc("seal_programs", None)

    def stats_bundle(self):
        try:
            res = self._rpc("stats_bundle")
        except TransportError:
            # dead worker: its counters died with it — the last
            # successful bundle is the honest remainder (the JOURNAL,
            # not stats, is the source of truth for requests)
            if self._last_bundle is not None:
                return self._last_bundle
            return {"snapshot": _EMPTY_SNAPSHOT.copy(), "stats": {}}
        if self.tracer is not None and res.get("tel"):
            self.tracer.ingest(res["tel"], ts_offset=self._ts_offset)
        bundle = {"snapshot": res["snapshot"], "stats": res["stats"]}
        self._last_bundle = bundle
        return bundle

    def clear_finished(self):
        self._rpc("clear_finished")
        self._last_bundle = None

    # -- chaos wiring --------------------------------------------------------
    def chaos_attach(self, **cfg):
        """Build + attach a seeded ChaosMonkey INSIDE the worker (the
        config is recorded and replayed on respawn with the same
        seed)."""
        self._chaos_cfg = dict(cfg)
        self._rpc("chaos_attach", self._chaos_cfg)

    def chaos_counts(self) -> dict:
        return self._rpc("chaos_counts")

    def chaos_wedge(self):
        self._rpc("chaos_wedge")

    def debug_check(self):
        return self._rpc("debug_check")


_EMPTY_SNAPSHOT = {
    "itl_parts": [], "goodput_tokens": 0, "finished": 0,
    "prefix_hit_tokens": 0, "prefix_query_tokens": 0,
    "generated_tokens": 0, "preemptions": 0, "aborted": 0,
    "failed": 0, "retries": 0, "dispatch_exhaustions": 0,
    "device_dispatches": 0, "program_compiles": 0,
    "unexpected_recompiles": 0, "load": 0,
}
