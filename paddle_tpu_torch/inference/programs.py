"""The serving engine's programs, one per static key.

Counterpart: the ``jax.jit`` program families the JAX engine builds
(``paddle_tpu/inference/serving.py:700-860``), each compiled once per
operand shape. Here a family is a Python function of a key (the static
shape and flags) and int32 / float32 operands; ``ProgramSet`` keeps one
program per (family, key):

- On a CUDA device a program is a ``torch.cuda.CUDAGraph``. Its
  operands live in one static int32 buffer (float32 operands are its
  bits); a dispatch packs the host arrays into a pinned staging buffer,
  copies it into the static buffer without blocking the host, and
  replays the graph. The staging buffer is rewritten only after the
  event of its previous copy has passed.
- On the CPU, or with ``graphs=False``, a program is its function, run
  eagerly on tensors made from the host arrays.

A key's first use before ``seal`` is its "compile": on the card an
eager run on a side stream first (it builds the kernel library, copies
the flash work lists to the device and sizes the paged kernels' counter
buffer, none of which a capture may do), then the capture. The eager
run's launches are not counted, and the tensors a family names in
``preserve`` get their contents back after it, so neither the launch
counters nor the state a replay reads see it. (It rewrites the K/V
slots of its own rows, which the replay writes again before any row
reads them.) Random draws take their keys from the operands, so a
replay draws exactly what the eager run of the same operands draws.
After ``seal`` an unseen key runs eagerly and counts as an unexpected
recompile, the analogue of a retrace. A capture that fails raises.

Kernel launch counters are Python module counters, which a replay does
not touch: each graph records the counters' growth over its capture and
adds it on every replay, so a counter still reads the launches the
device ran for the dispatches made.

Graphs of one engine share one memory pool, so a graph's outputs may be
overwritten by the next replay of any graph. A caller consumes them in
stream order right after the replay (a host copy queued behind it); an
output read by a later dispatch is copied inside the graph into a
buffer the caller owns.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda import decode_matmul as _dmm
from ..ops.cuda import flash_attention as _cfa
from ..ops.cuda import paged_attention_decode as _pdc
from ..ops.cuda import ragged_paged_attention as _rpa
from ..utils.telemetry import CompileWatch

__all__ = ["ProgramSet"]

# the launch counters of the kernels a serving program may run
_COUNTERS = ((_rpa, "launches"), (_pdc, "launches"), (_dmm, "launches"),
             (_cfa, "launches_fwd"), (_cfa, "launches_dq"),
             (_cfa, "launches_dkv"))


def _read_counters():
    return [getattr(m, a) for m, a in _COUNTERS]


def _write_counters(values):
    for (m, a), v in zip(_COUNTERS, values):
        setattr(m, a, v)


def _pack(dst: np.ndarray, arrays: Sequence[np.ndarray]):
    """Write 4-byte arrays into the flat int32 ``dst``, in order."""
    off = 0
    for a in arrays:
        flat = np.ascontiguousarray(a).reshape(-1).view(np.int32)
        dst[off:off + flat.size] = flat
        off += flat.size


def _views(buf: torch.Tensor, arrays: Sequence[np.ndarray]):
    """Views of the flat int32 ``buf`` with each array's shape and
    dtype."""
    out, off = [], 0
    for a in arrays:
        n = int(a.size)
        v = buf[off:off + n].view(a.shape)
        if a.dtype == np.float32:
            v = v.view(torch.float32)
        out.append(v)
        off += n
    return out


def _check_arrays(arrays):
    for a in arrays:
        if a.dtype not in (np.int32, np.float32):
            raise TypeError(f"program operands are int32 or float32, got "
                            f"{a.dtype}")


class _Graph:
    """One captured program: its static operand buffer, pinned staging,
    the graph, its outputs and its launch-counter growth."""

    def __init__(self, static, staging, graph, outs, deltas):
        self.static = static
        self.staging = staging
        self.staging_np = staging.numpy()
        self.graph = graph
        self.outs = outs
        self.deltas = deltas
        # passed when the last copy out of ``staging`` is done
        self.event = torch.cuda.Event()

    def replay(self, arrays, events=None):
        self.event.synchronize()
        _pack(self.staging_np, arrays)
        self.static.copy_(self.staging, non_blocking=True)
        self.event.record()
        if events is not None:
            events[0].record()
        self.graph.replay()
        if events is not None:
            events[1].record()
        _write_counters([c + d for c, d in zip(_read_counters(),
                                                self.deltas)])
        return self.outs


class ProgramSet:
    """The programs of one engine on ``device``."""

    def __init__(self, device, watch: CompileWatch, graphs: bool = True,
                 devices: Sequence = ()):
        self.device = torch.device(device)
        self.watch = watch
        self.graphs = bool(graphs) and self.device.type == "cuda"
        # a tensor-parallel engine's shards: one graph holds them all on
        # one card; across cards a capture would need one graph per card
        cards = {torch.device(d) for d in devices} | {self.device}
        if self.graphs and len({(d.type, d.index or 0)
                                for d in cards}) > 1:
            raise NotImplementedError(
                f"CUDA graphs of a tensor-parallel engine whose shards span "
                f"distinct cards ({sorted(map(str, cards))}) are not ported "
                f"yet (ROADMAP queue 1, item 11(d)); pass cuda_graphs=False "
                f"to run its programs eagerly")
        self._fns: Dict[str, Callable] = {}
        self._preserve: Dict[str, tuple] = {}
        self._graphs: Dict[Tuple[str, tuple], _Graph] = {}
        self._pool = None
        # compiles / unexpected recompiles since the last reset_stats
        self.compiles = 0
        self.unexpected = 0
        # dispatches per (family, key)
        self.dispatches: Counter = Counter()

    def register(self, family: str, fn: Callable,
                 preserve: Sequence[torch.Tensor] = (), **info):
        """``fn(key, *operands)`` returns a tuple of tensors; it may also
        write the tensors of ``preserve``, which a compile's eager run
        leaves as they were."""
        self._fns[family] = fn
        self._preserve[family] = tuple(preserve)
        self.watch.register(family, **info)

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def reset_stats(self):
        self.compiles = 0
        self.unexpected = 0

    def run(self, family: str, key: tuple, arrays: Sequence[np.ndarray],
            events=None):
        """Dispatch one program: its outputs on the device. ``events``,
        a pair of CUDA events, are recorded just before and just after
        the program (its graph's replay, or its eager run once the
        operands are on the card)."""
        _check_arrays(arrays)
        self.dispatches[(family, key)] += 1
        if self.graphs:
            g = self._graphs.get((family, key))
            if g is None and not self.watch.sealed:
                g = self._capture(family, key, arrays)
            if g is not None:
                return g.replay(arrays, events)
        t0 = time.perf_counter()
        operands = self._operands(arrays)
        if events is not None:
            events[0].record()
        out = self._fns[family](key, *operands)
        if events is not None:
            events[1].record()
        self._observe(family, key, t0, arrays)
        return out

    def prepare(self, family: str, key: tuple,
                arrays: Sequence[np.ndarray]):
        """Compile one program without dispatching it: capture it on the
        card, or run it once eagerly on the CPU with the family's
        preserved tensors restored. A key already compiled is left
        alone."""
        _check_arrays(arrays)
        if self.graphs:
            if (family, key) not in self._graphs:
                self._capture(family, key, arrays)
        elif not self.watch.seen(family, key):
            t0 = time.perf_counter()
            with self._aside(family):
                self._fns[family](key, *self._operands(arrays))
            self._observe(family, key, t0, arrays)

    def close(self):
        """Drop every graph and the pool they share."""
        self._graphs.clear()
        self._pool = None

    # -- internals -----------------------------------------------------------
    def _observe(self, family, key, t0, arrays):
        new, unexpected = self.watch.observe(family, key, t0,
                                             time.perf_counter(), arrays)
        self.compiles += new
        self.unexpected += unexpected

    @contextlib.contextmanager
    def _aside(self, family):
        """A compile's eager run: the family's preserved tensors restored
        afterwards."""
        saved = [t.clone() for t in self._preserve[family]]
        try:
            yield
        finally:
            for t, c in zip(self._preserve[family], saved):
                t.copy_(c)

    def _operands(self, arrays):
        """Eager operands: CPU tensors over the arrays, or on the card one
        non-blocking copy of them all through pinned memory."""
        if self.device.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays]
        staging = torch.empty(sum(int(a.size) for a in arrays),
                              dtype=torch.int32, pin_memory=True)
        _pack(staging.numpy(), arrays)
        return _views(staging.to(self.device, non_blocking=True), arrays)

    def _capture(self, family, key, arrays) -> _Graph:
        t0 = time.perf_counter()
        dev = self.device
        fn = self._fns[family]
        n = sum(int(a.size) for a in arrays)
        static = torch.empty(n, dtype=torch.int32, device=dev)
        staging = torch.empty(n, dtype=torch.int32, pin_memory=True)
        _pack(staging.numpy(), arrays)
        static.copy_(staging)
        operands = _views(static, arrays)
        before = _read_counters()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), self._aside(family):
            fn(key, *operands)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        start = _read_counters()
        with torch.cuda.graph(graph, pool=self._pool):
            outs = fn(key, *operands)
        deltas = [b - a for a, b in zip(start, _read_counters())]
        _write_counters(before)
        g = _Graph(static, staging, graph, tuple(outs), deltas)
        self._graphs[(family, key)] = g
        self._observe(family, key, t0, arrays)
        return g
