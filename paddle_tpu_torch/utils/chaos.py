"""Deterministic fault injection for the serving engine.

Counterpart: ``paddle_tpu/utils/chaos.py``, copied whole (``ChaosMonkey``
and the ``Injected*`` errors), with the port's ``KVCacheExhausted``. The
monkey injects seeded failures at the engine's fault surfaces:

- allocator OOM: ``PagedKVCache.fault_hook`` fires at the top of every
  ``_take_block``, before any pool mutation, raising KVCacheExhausted
  exactly as a dry pool would. The engine answers with admission
  back-pressure or preemption with recompute.
- dispatch faults: ``ServingEngine._device_call`` consults
  ``before_call`` ahead of every program dispatch. The error is raised
  before the program runs, so a retry replays the identical program
  (same operands, same keys) and recovery is token-identical.
- collection faults: the same hook ahead of every host copy of a
  program's tokens. A retried collection reads the same tokens.
- latency spikes: a seeded ``time.sleep`` ahead of a call.

One ``numpy.random.RandomState(seed)`` drives everything, so the same
seed and the same engine behaviour give the same schedule. The monkey
never changes engine state itself: it only raises or sleeps at the
hooks. The transport hooks (``transport_fault``, ``kill``) serve the
multi-process transport of the fleet (``inference/transport.py``) and are
kept as in the JAX package.

Usage::

    from paddle_tpu_torch.utils.chaos import ChaosMonkey
    monkey = ChaosMonkey(seed=0, p_dispatch=0.05, p_alloc_oom=0.02)
    monkey.attach(engine)
    while engine.step():
        engine.dec.cache.debug_check()
    monkey.detach(engine)
    print(monkey.counts, monkey.log)
"""
from __future__ import annotations

import os
import signal
import time
from collections import Counter
from typing import List, Tuple

import numpy as np

from ..ops.paged_attention import KVCacheExhausted

__all__ = ["ChaosMonkey", "InjectedFault", "InjectedDispatchError",
           "InjectedCollectError", "InjectedTransportError"]


class InjectedFault(RuntimeError):
    """Base of every chaos-injected failure (NOT KVCacheExhausted —
    injected allocator OOM deliberately raises the real exhaustion type
    so the engine cannot tell it from true pressure)."""


class InjectedDispatchError(InjectedFault):
    """Injected ahead of a device dispatch (transient device error)."""


class InjectedCollectError(InjectedFault):
    """Injected ahead of a result fetch (torn/corrupt collection)."""


class InjectedTransportError(InjectedFault):
    """Injected at a ProcTransport RPC boundary: raised by
    ``transport_fault`` before a send (dropped request) or after a
    receive (dropped response). The transport's bounded retry treats
    it exactly like a real torn pipe — and because retries re-use the
    message id against the worker's reply cache, a dropped RESPONSE is
    the deterministic exactly-once test: the reply crosses twice, the
    step ran once, the journal extends once."""


class ChaosMonkey:
    """Seeded, deterministic fault injector for one ServingEngine.

    p_alloc_oom:  probability a block take raises KVCacheExhausted
    p_dispatch:   probability a dispatch raises InjectedDispatchError
    p_collect:    probability a fetch raises InjectedCollectError
    p_latency:    probability a call is delayed by latency_s first
    p_rpc_drop:   probability a transport RPC stage (send/recv) raises
                  InjectedTransportError (parent-side hook)
    p_rpc_delay:  probability an RPC stage sleeps latency_s first
    """

    def __init__(self, seed: int = 0, p_alloc_oom: float = 0.0,
                 p_dispatch: float = 0.0, p_collect: float = 0.0,
                 p_latency: float = 0.0, latency_s: float = 0.002,
                 p_rpc_drop: float = 0.0, p_rpc_delay: float = 0.0):
        self.rng = np.random.RandomState(seed)
        self.p_alloc_oom = float(p_alloc_oom)
        self.p_dispatch = float(p_dispatch)
        self.p_collect = float(p_collect)
        self.p_latency = float(p_latency)
        self.latency_s = float(latency_s)
        self.p_rpc_drop = float(p_rpc_drop)
        self.p_rpc_delay = float(p_rpc_delay)
        self.counts: Counter = Counter()
        # (call index, site) of every injection, for post-mortems
        self.log: List[Tuple[int, str]] = []
        self._calls = 0
        # the attached engine (telemetry: injections are emitted into
        # its flight recorder when a tracer is enabled, so every red
        # gate run's export shows exactly which faults were injected
        # when, next to the spans they hit)
        self._engine = None

    # -- wiring -------------------------------------------------------------
    def attach(self, engine) -> "ChaosMonkey":
        """Hook this monkey into `engine` (and its KV pool)."""
        engine.chaos = self
        engine.dec.cache.fault_hook = self._alloc_hook
        self._engine = engine
        return self

    def detach(self, engine):
        if engine.chaos is self:
            engine.chaos = None
        if engine.dec.cache.fault_hook == self._alloc_hook:
            engine.dec.cache.fault_hook = None
        if self._engine is engine:
            self._engine = None

    def _trace_event(self, site: str, **attrs):
        eng = self._engine
        tracer = getattr(eng, "tracer", None) if eng is not None \
            else None
        if tracer is not None:
            tracer.event("injected_fault",
                         pid=getattr(eng, "replica_id", 0),
                         site=site, **attrs)

    def wedge(self):
        """Turn this monkey into a PERSISTENT replica wedge:
        from now on EVERY dispatch and every fetch raises — the model
        of a replica whose device/link died outright, as opposed to
        the transient faults the probabilities above inject. The
        attached engine's bounded retry exhausts on every call and
        fails the riding requests; above it, the fleet Router reads
        the exhaustion stream as consecutive strikes, trips its
        circuit breaker, and drains the replica. Latency/OOM injection keeps its configured rates —
        a wedged device still answers allocator bookkeeping, which is
        host-side anyway."""
        self.p_dispatch = 1.0
        self.p_collect = 1.0
        self.counts["wedged"] += 1
        self.log.append((self._calls, "wedge"))
        self._trace_event("wedge")
        return self

    def kill(self):
        """SIGKILL the CURRENT process — the hard-death analogue of
        wedge(): wedge models a device/link that died while
        the host survives; kill models the host process itself dying
        (OOM killer, segfault). Meant to run INSIDE a ProcTransport
        worker (the transport's ``chaos_kill`` verb / ``inject_kill``)
        — the Router observes pipe EOF + waitpid, wedges the replica,
        drains its journal and respawns. Counts/log/trace are emitted
        best-effort first, but a SIGKILL'd process flushes nothing:
        the parent-side counters are the ones that survive."""
        self.counts["kills"] += 1
        self.log.append((self._calls, "kill"))
        self._trace_event("kill")
        os.kill(os.getpid(), signal.SIGKILL)

    def transport_fault(self, stage: str, verb: str):
        """ProcTransport consults this ahead of every RPC send and
        after every receive (``stage`` is 'send' or 'recv'). Raising
        InjectedTransportError models a dropped request / dropped
        response; the transport's bounded retry + the worker's reply
        cache make recovery exactly-once by construction. A seeded
        delay models a slow pipe without failing anything."""
        self._calls += 1
        self.counts["rpc_stages"] += 1
        if self.p_rpc_delay and \
                self.rng.random_sample() < self.p_rpc_delay:
            self.counts["rpc_delays"] += 1
            self.log.append((self._calls, f"rpc_delay:{stage}:{verb}"))
            time.sleep(self.latency_s)
        if self.p_rpc_drop and \
                self.rng.random_sample() < self.p_rpc_drop:
            self.counts["rpc_drops"] += 1
            self.log.append((self._calls, f"rpc_drop:{stage}:{verb}"))
            self._trace_event("rpc_drop", stage=stage, verb=verb)
            raise InjectedTransportError(
                f"chaos: injected rpc {stage} drop at {verb}")

    # -- injection sites ----------------------------------------------------
    def _alloc_hook(self):
        self._calls += 1
        self.counts["alloc_calls"] += 1
        if self.p_alloc_oom and \
                self.rng.random_sample() < self.p_alloc_oom:
            self.counts["alloc_oom"] += 1
            self.log.append((self._calls, "alloc_oom"))
            self._trace_event("alloc_oom")
            raise KVCacheExhausted("chaos: injected allocator OOM")

    def before_call(self, engine, kind: str):
        """ServingEngine._device_call consults this ahead of every
        dispatch/fetch; `kind` is 'dispatch:*' or 'collect:*'. Raising
        here is always retry-safe: the underlying call has not run, so
        nothing was donated or consumed."""
        self._calls += 1
        self.counts["device_calls"] += 1
        if self.p_latency and \
                self.rng.random_sample() < self.p_latency:
            self.counts["latency_spikes"] += 1
            self.log.append((self._calls, f"latency:{kind}"))
            time.sleep(self.latency_s)
        if kind.startswith("collect"):
            if self.p_collect and \
                    self.rng.random_sample() < self.p_collect:
                self.counts["collect_faults"] += 1
                self.log.append((self._calls, kind))
                self._trace_event("collect_fault", kind=kind)
                raise InjectedCollectError(
                    f"chaos: injected collection fault at {kind}")
        else:
            if self.p_dispatch and \
                    self.rng.random_sample() < self.p_dispatch:
                self.counts["dispatch_faults"] += 1
                self.log.append((self._calls, kind))
                self._trace_event("dispatch_fault", kind=kind)
                raise InjectedDispatchError(
                    f"chaos: injected dispatch fault at {kind}")
