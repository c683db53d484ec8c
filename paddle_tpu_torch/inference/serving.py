"""Continuous-batching serving engine over the paged KV pool.

Counterpart: ``paddle_tpu/inference/serving.py``. Two schedulers, chosen
by ``ragged`` with the JAX package's default (``False``):

The DENSE per-phase path (``ragged=False``). Each step dispatches
prefill work, then one decode chunk:
- prefill, oldest request first. A prompt longer than ``prefill_chunk``
  goes out as width-1 no-sample MID chunks of exactly that many tokens
  (``_prefill_impl`` at offset 0, ``_prefill_prefix_impl`` without
  logits after that, over a power-of-two ladder of prefix-table widths); a prompt's last
  dispatch is its sampling FINAL, right-padded to its ``prompt_buckets``
  bucket and grouped with other ready finals of that bucket (padded to
  ``PREFILL_GROUP`` rows). A final at an offset takes
  ``_prefill_prefix_impl``. While decodes run, the prefill tokens of a
  step are capped at ``prefill_budget``.
- decode: T steps (``chunk_size`` or a rung of ``chunk_schedule``) of
  ``PagedLlamaDecoder._decode_logits`` over all ``max_batch_size``
  slots, from a host-precomputed [T, mb, max_pages] schedule; inactive
  or drained slots aim at the scratch page with ctx 0. Each step's
  sampled token feeds the next on the device, and a chunk's first
  tokens come from the previous decode chunk's device output (a
  ``torch.where`` against host values for fresh slots, inside the
  chunk's program, over an engine-owned copy of that output).
With ``overlap=True`` one decode chunk stays in flight while the host
schedules the next (not while a running request uses a repetition
penalty: its seen mask needs the fetched history, as in JAX). Every
chunk's tokens are copied to pinned host memory behind an event right
after its dispatch; waiting on that event at collection is the only
host sync of the dense path.

The RAGGED path (``ragged=True``). Every step is ONE unified chunk: a
[T, W] schedule of flattened rows run as T sequential ministeps of
``PagedLlamaDecoder._ragged_logits``.
Decode columns (one per running request) carry their sampled token from
one ministep to the next on the device; prefill rows (a budget of prompt
tokens per step, spread ministep-major over the columns past the decode
columns) write K/V only, except a prompt's final row, which samples the
request's first token. W is the real row count padded up a rung of
``RAGGED_WIDTHS``. An idle engine keeps dispatching pure-prefill chunks
within one step; such a chunk keeps the width of the chunk before it
while T is unchanged (the sticky width), and a wider one first
collects the chunks in flight, as JAX does. Each chunk's [T, W] tokens
are copied to pinned host memory behind an event right after its
dispatch, and collected before the step returns: the ragged path
schedules as JAX's ragged engine with ``overlap=False``.

Admission (``admission``): ``"worst_case"`` (the default) admits a
request only when its prompt plus ``max_new_tokens`` fits the blocks it
can claim, so a running request never exhausts the pool.
``"optimistic"`` reserves the prefill and one decode slot and grows on
demand; under pressure the engine preempts the lowest-priority, newest
request (``_pick_victim``): its blocks are freed at once, it goes back
to the queue, and on re-admission prompt ++ its generated history is
prefilled again through the no-sample programs (dense mid chunks,
ragged prefill rows), so no key is drawn for it and greedy streams are
token-identical. Epochs drop a dead life's in-flight tokens at
collection, and a victim's rows already placed in the chunk being built
are re-aimed at the scratch page (dense ``neutralize``, ragged
``blank``). A prompt longer than the largest prompt bucket is refused
at ``add_request`` on both paths, as in JAX. One scratch page takes the
writes of padding rows; table row ``max_batch_size`` is the scratch row
the ragged path's padding rows read.

Faults, as in JAX: ``cancel`` and ``SamplingParams.deadline_s`` move a
request to the terminal state ``aborted`` from any live state (partial
tokens kept); ``add_request`` raises ``EngineOverloaded`` at the
``max_queue_depth`` cap or when the backlog over the measured token
rate misses the deadline; every dispatch and every collection goes
through ``_device_call``: ``ChaosMonkey`` injection (``utils/chaos.py``),
then up to ``max_dispatch_retries`` retries of the same call with the
same operands and keys, then the terminal state ``failed`` with
``Request.error`` for the requests it carried. ``step()`` never raises
on a per-request fault. With ``PADDLE_TPU_POOL_DEBUG=1`` the pool
invariant is checked after every step.

Prefix caching (``prefix_caching=True``, the default, as in JAX): at
admission ``PagedKVCache.allocate_with_prefix`` splices the cached full
blocks of the longest matching prompt prefix into the request's table,
and only the suffix past ``n_cached`` is prefilled (the dense path's
finals and mid chunks at that offset, the ragged path's rows from
``n_cached``). The request's own full prompt blocks enter the hash
index at once; a later request that splices one of them before its
writer has dispatched the rows covering it waits (``_deps_ready``), so
on the device a reader always follows its writer. A decoder outlives
its engines, so an engine starts from a clean index and clears it again
at ``close()``.

Every device dispatch goes through ``self.programs``
(``inference/programs.py``), one program per static key: the ragged
chunk per (T, W, sampled, rich), the dense decode chunk per (T,
sampled, rich), the final prefill per (bucket, rows, sampled, rich),
plain and prefix, and the no-sample mid chunk at offset 0 and per
prefix-page width. On the card each program is a CUDA graph
(``cuda_graphs=True``, the default); ``warmup_programs`` captures the
whole reachable grid without touching the pool or the key stream, and
``seal_programs`` closes the set: a key first seen after it runs
eagerly and counts in ``unexpected_recompiles``.

Sampling draws on JAX's threefry key stream (``utils/prng.py``): the
engine key starts at ``PRNGKey(seed)`` and each dispatch that samples
or could sample consumes one ``_next_key()`` as the JAX engine does,
greedy or not (a decode or ragged chunk splits it into T ministep keys,
a final uses it whole; mid chunks and resumes draw none). Keys reach a
program as operands, so eager runs and graph replays draw the same
numbers, and a token is ``categorical(key, logits / T)``: JAX's Gumbel
draw. ``sampled`` (some row of the dispatch has temperature > 0)
decides whether a program computes the draw at all. A request with
per-request ``top_k``, ``top_p``, ``repetition_penalty`` or
``allowed_tokens`` makes its dispatch ``rich`` (``_sample_rich``); the
[rows, vocab] seen and allowed masks live in engine-owned device
planes, rewritten row by row before the dispatch only where their
content changes. Serving runs under ``torch.inference_mode()``.

Three program families ride the ragged path, each forcing
``ragged=True`` as in JAX:
- ``multi_step=k`` fuses k pure-decode steps into one window of k * T
  ministeps (only while no slot is prefilling). Each column carries its
  EOS id; once it samples it, later ministeps aim its writes at the
  scratch slot and freeze its token (a per-column ``live`` mask), and
  collection cuts the stream at the EOS. Cancels and deadlines take
  effect at the window's boundary. The window's keys are
  ``split(_next_key(), k * T)``, as JAX's fused dispatch draws them.
- ``spec_decode=SpecConfig(...)`` verifies a drafter's proposals: each
  greedy running column rides one ministep as its carried token plus
  up to ``draft_len`` draft rows at the next positions, prefill rows
  fill what is left of the row budget, ``_spec_accept`` keeps the
  longest prefix that matches the model's own tokens and zeroes the
  rejected rows' K/V, and collection delivers 1..draft_len + 1 tokens a
  column and rolls the allocator back past the rest. A rich request
  anywhere in the slots pauses speculation.
- ``lora=AdapterRegistry(...)`` serves per-request adapters
  (``SamplingParams.adapter_id``): an adapter is acquired at admission
  and released whenever its request leaves its slot, its pages share
  the KV pool, and a dispatch with any adapter row runs the lora twin
  of its program, which gathers each slot's adapter pages once and adds
  every row's delta. A dispatch of base requests only runs the base
  program, so base traffic is bit-identical to an engine without a
  registry. The prefix index is salted with the adapter id.

``ServingEngine(model, ...)`` builds its decoder from a
``LlamaForCausalLM`` (``PagedLlamaDecoder.from_model``), as JAX's does,
so a model the port trained is served as it stands.

Telemetry, as in JAX (``utils/telemetry.py``): ``tracer=`` records one
async span per request (``begin_request`` at submission, ``end_request``
at every terminal state, one trace id across preemption and, through
``adopt_request``, across replicas), a queued / prefill / splice_wait /
decode span per life, per-step events (dispatch, preempt, shed, retry,
adopt, slo_violation, and the pool's kv_* and the registry's refault
events) and per-step counter tracks; ``stats()`` is mirrored into the
tracer's registry under ``engine`` (``engine{r}`` for replica r).
``slo=`` feeds TTFT once per request and ITL at collection into an
``SLOMonitor`` (``stats()["slo"]``). ``profile_every=n`` splits every
n-th dispatch's wall (seeded start phase) into host-schedule (since the
previous device call ended), dispatch-queue (a
``torch.cuda.synchronize()`` draining earlier work, timed on the host)
and device-execute (CUDA events around the program; on the CPU the
host wall of the eager call). ``tracer=None`` is a bitwise no-op.
``adopt_request`` admits a request that ran on another engine (the
fleet Router's migration): its history re-enters through the
preemption-recompute path, so no key is drawn.

Tensor parallelism, as in JAX: ``tp=N`` builds the decoder over a
``ProcessMesh`` of the first N of ``devices`` (default: the visible
cards; a device may repeat) with one weight tree and pool plane per
shard (``PagedLlamaDecoder``), forces the ragged path, and samples the
gathered logits on the first shard's device, so the key stream is
unchanged. ``tp_comm`` picks the all-reduce ("fp32" or "int8"); a
prebuilt decoder's degree and comm mode must match the engine's;
``mesh=`` is JAX's GSPMD decoder placement (tp 1 for the engine), and
``devices=`` at tp 1 raises. Every program family runs at tp; a program
key of one engine is one CUDA graph that holds every shard's kernels
when the shards share a card.
"""
from __future__ import annotations

import functools
import itertools
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.mesh import ProcessMesh
from ..distributed.spec_layout import SpecLayout, default_devices
from ..ops.paged_attention import KVCacheExhausted
from ..utils import prng
from ..models.llama import LlamaForCausalLM
from ..utils.telemetry import (CompileWatch, MetricsRegistry, Reservoir,
                               SLOMonitor)
from .lora import AdapterRegistry
from .paged_decode import PagedLlamaDecoder, _PagedDecoder
from .programs import ProgramSet
from .spec_decode import SpecConfig

__all__ = ["EngineOverloaded", "SamplingParams", "Request",
           "ServingEngine", "SpecConfig"]


class EngineOverloaded(RuntimeError):
    """Admission refused by overload shedding: the queue is at
    ``max_queue_depth``, or the backlog over the engine's measured token
    rate says the request cannot meet its deadline. Raised by
    ``add_request`` before the request is queued."""


class _DispatchFailed(Exception):
    """A dispatch or collection exhausted its retries: the site kind and
    the last exception. The call site fails the requests involved; the
    engine keeps serving."""

    def __init__(self, kind: str, cause: BaseException):
        super().__init__(f"{kind}: {cause!r}")
        self.kind = kind
        self.cause = cause


@dataclass
class SamplingParams:
    """Per-request sampling, the JAX package's fields. temperature <= 0
    is greedy; top_k None defers to the engine's top_k and 0 disables
    it; top_p 1.0 and repetition_penalty 1.0 are off; allowed_tokens is
    a bool mask of length vocab or a list of token ids; deadline_s is a
    wall-clock budget from submission; a higher priority is preempted
    later; adapter_id names an adapter of the engine's registry (None:
    the base model)."""
    temperature: float = 0.0
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    top_k: Optional[int] = None
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    deadline_s: Optional[float] = None
    priority: int = 0
    adapter_id: Optional[object] = None
    allowed_tokens: Optional[object] = None

    @property
    def needs_rich_sampling(self) -> bool:
        # an explicit top_k (0 included, which overrides an engine
        # default) takes the per-request path, as does a vocab mask
        return (self.top_k is not None or self.top_p < 1.0
                or self.repetition_penalty != 1.0
                or self.allowed_tokens is not None)


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                    # [prompt_len] int32
    sampling: SamplingParams
    out_tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    # queued | prefilling | running | done, and the terminal fault
    # states aborted (cancel, deadline) and failed (error says why)
    state: str = "queued"
    error: Optional[str] = None
    planned: int = 0                      # tokens scheduled (prefill final + decode)
    # preemption with recompute: a request preempted while running
    # resumes by prefilling ctx = prompt ++ out_tokens[:-1] through the
    # no-sample programs and decodes on from out_tokens[-1]; epoch is
    # bumped whenever the request loses its slot, so collection drops
    # a previous life's tokens
    resume: bool = False
    ctx: Optional[np.ndarray] = None
    epoch: int = 0
    n_cached: int = 0                     # prefill tokens spliced from a cache
    prefill_sent: int = 0                 # prefill tokens dispatched so far
    slot: Optional[int] = None
    itls: List[float] = field(default_factory=list)
    t_last_emit: Optional[float] = None
    # prefix splices: (writer, writer's prefill_sent that covers the
    # spliced blocks) pairs, and this request's own full prompt blocks
    # that readers may splice before this request's rows are dispatched
    deps: List[tuple] = field(default_factory=list)
    pending_blocks: List[int] = field(default_factory=list)
    # allowed_tokens as a [vocab] bool mask (None: unrestricted), and a
    # serial naming it in the engine's allowed-mask plane
    allowed_mask: Optional[np.ndarray] = None
    allowed_serial: int = 0
    # holds one AdapterRegistry.acquire of its adapter
    lora_held: bool = False
    # telemetry (None / 0 while no tracer is attached): the request's
    # async-span id, kept across lives and replicas; the current queued
    # life's start, slot admission, running transition and splice-wait
    # start; and keep-open, which the fleet Router sets before it
    # cancels a request it migrates, so the abort does not end the span
    trace_id: Optional[int] = None
    t_queued: float = 0.0
    t_life: float = 0.0
    t_run: Optional[float] = None
    t_wait: Optional[float] = None
    trace_keep_open: bool = False

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What the current allocation prefills: the prompt, or prompt
        ++ generated history for a resume."""
        return self.ctx if self.ctx is not None else self.prompt

    @property
    def suffix_len(self) -> int:
        """Prefill tokens that must run (past a cached prefix; without
        prefix caching, n_cached is 0)."""
        return int(len(self.prefill_tokens)) - self.n_cached

    @property
    def deadline_at(self) -> Optional[float]:
        if self.sampling.deadline_s is None:
            return None
        return self.t_submit + self.sampling.deadline_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


def _normalize_prompt(prompt) -> np.ndarray:
    """Prompt intake: tensor or sequence to a flat int32 array; an empty
    prompt is rejected."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if prompt.size == 0:
        raise ValueError("empty prompt")
    return prompt


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt length {n} exceeds the largest prefill bucket: "
        f"configured prompt_buckets={tuple(buckets)} top out at "
        f"{buckets[-1]} tokens; raise prompt_buckets (or shorten the "
        f"prompt)")


class _MaskPlanes:
    """The [rows, vocab] bool planes the rich programs read: ``seen``
    (tokens a repetition-penalty row has seen) and ``allowed`` (its
    vocab mask). Their addresses stay fixed, as captured graphs read
    them. ``write`` brings the rows a dispatch consumes to the content
    it names, copying only rows whose content differs from what they
    hold; copies are queued on the current stream ahead of the
    dispatch, so earlier programs read the old rows. A program that
    updates ``seen`` does so on a clone."""

    def __init__(self, rows: int, vocab: int, device):
        self.seen = torch.zeros((rows, vocab), dtype=torch.bool,
                                device=device)
        self.allowed = torch.ones((rows, vocab), dtype=torch.bool,
                                  device=device)
        self.vocab = vocab
        # what each row holds: a seen row's (request, tokens) or None
        # (no token seen), an allowed row's mask serial (0: all ones)
        self._held = {"seen": [None] * rows, "allowed": [0] * rows}

    def write(self, plane: str, wanted: Dict[int, tuple]):
        """``wanted`` maps a row to (content key, numpy [vocab] bool row,
        or a function making it). Rows not named are left as they
        are."""
        held = self._held[plane]
        rows = [r for r, (k, _) in sorted(wanted.items()) if held[r] != k]
        if not rows:
            return
        data = np.stack([self._row(wanted[r][1]) for r in rows])
        dst = getattr(self, plane)
        src = torch.from_numpy(data)
        idx = torch.as_tensor(rows, dtype=torch.long)
        if dst.device.type == "cuda":
            src = src.pin_memory().to(dst.device, non_blocking=True)
            idx = idx.pin_memory().to(dst.device, non_blocking=True)
        dst.index_copy_(0, idx, src)
        for r in rows:
            held[r] = wanted[r][0]

    def _row(self, content):
        row = content() if callable(content) else content
        return np.asarray(row, bool).reshape(self.vocab)


class _ChunkRows:
    """The row operands of one ragged chunk or verify ministep while it
    is built: [T, W] planes (ids, positions, slots, row_seq, row_ctx,
    temperatures, and the family's own planes), which request rides
    which cells, and the staleness sweep. A cell never written, or
    blanked, holds its plane's initial value: the scratch slot and row,
    nothing sampled."""

    BASE = ("ids", "pos", "slots", "rseq", "rctx", "temps")

    def __init__(self, T: int, W: int, scratch_slot: int, scratch_row: int,
                 **extra: np.ndarray):
        init = dict(ids=np.zeros((T, W), np.int32),
                    pos=np.zeros((T, W), np.int32),
                    slots=np.full((T, W), scratch_slot, np.int32),
                    rseq=np.full((T, W), scratch_row, np.int32),
                    rctx=np.zeros((T, W), np.int32),
                    temps=np.zeros((T, W), np.float32), **extra)
        self.names = tuple(init)
        self._init = {n: a.copy() for n, a in init.items()}
        for n, a in init.items():
            setattr(self, n, a)
        self.rows_of: Dict[int, List[Tuple[int, int]]] = {}
        self.sched: Dict[int, Tuple[Request, int]] = {}  # req_id -> epoch
        self.take_of: Dict[int, int] = {}       # req_id -> prefill rows
        self.finals: List[tuple] = []           # (req, epoch, t, c)

    def set_sampling(self, t: int, c: int, sp: SamplingParams,
                     top_k: int):
        self.temps[t, c] = sp.temperature
        if "top_ks" in self.names:
            self.top_ks[t, c] = top_k if sp.top_k is None else sp.top_k
            self.top_ps[t, c] = sp.top_p
            self.reps[t, c] = sp.repetition_penalty

    def sweep(self) -> List[Request]:
        """Blank every cell of a request that lost its life while the
        rows were built, before the dispatch, so a blanked row never
        writes into pages a survivor took. Returns those requests."""
        dropped = []
        for rid in list(self.sched):
            req, epoch = self.sched[rid]
            if (req.epoch == epoch and req.slot is not None
                    and req.state in ("running", "prefilling")):
                continue
            for t, c in self.rows_of.get(rid, []):
                for n in self.names:
                    getattr(self, n)[t, c] = self._init[n][t, c]
            self.take_of.pop(rid, None)
            self.finals[:] = [f for f in self.finals if f[0] is not req]
            del self.sched[rid]
            dropped.append(req)
        return dropped


def decoder_from_model(model, tp: int = 1, devices=None, device=None,
                       mesh=None, tp_comm: Optional[str] = None, **pool):
    """The paged decoder that serves ``model``, built by its family's
    ``from_model``: a ``PagedLlamaDecoder`` for a ``LlamaForCausalLM``, a
    ``PagedGPTDecoder`` for a ``GPTForCausalLM``. At tp > 1 the shards
    sit on a tp mesh over ``devices`` (None: the visible cards); else
    the decoder is built on ``device``, or placed by ``mesh``. ``pool``:
    ``num_blocks``, ``block_size``, ``weight_dtype``, ``kv_quant``."""
    from ..models.gpt import GPTForCausalLM
    from .gpt_decode import PagedGPTDecoder
    if isinstance(model, GPTForCausalLM):
        cls = PagedGPTDecoder
    elif isinstance(model, LlamaForCausalLM):
        cls = PagedLlamaDecoder
    else:
        raise TypeError(f"no paged decoder serves a "
                        f"{type(model).__name__}")
    if devices is not None and tp == 1:
        raise ValueError(
            "devices= requires tp > 1: a single-chip engine builds "
            "on the default device (the fleet Router passes "
            "devices only for tp-sharded replicas)")
    if tp > 1:
        devs = (list(devices) if devices is not None
                else default_devices())
        if len(devs) < tp:
            raise ValueError(f"tp={tp} needs {tp} devices, found "
                             f"{len(devs)}")
        if device is not None and any(
                torch.device(d).type != torch.device(device).type
                for d in devs[:tp]):
            raise ValueError(
                f"device={device!r} contradicts devices="
                f"{devs[:tp]!r}; at tp > 1 devices= places the "
                f"shards")
        mesh = ProcessMesh(list(range(tp)), ["tp"], devices=devs[:tp])
    return cls.from_model(
        model, device=device if mesh is None else None, mesh=mesh,
        mp_axis="tp" if tp > 1 else "mp", tp_shard_map=tp > 1,
        tp_comm=tp_comm or "fp32", **pool)


class ServingEngine:
    """Continuous-batching serving of a ``LlamaForCausalLM`` or a prebuilt
    ``PagedLlamaDecoder`` or ``PagedGPTDecoder`` (a ``GPTForCausalLM`` is
    served through ``PagedGPTDecoder.from_model``, as JAX serves GPT
    through its prebuilt decoder).

    Usage:
        eng = ServingEngine(model, weight_dtype="int4", max_batch_size=8)
        # or ServingEngine(PagedLlamaDecoder.from_config(cfg, ...), ...)
        rid = eng.add_request(prompt_ids, SamplingParams(max_new_tokens=64))
        eng.run_to_completion()
        tokens = eng.result(rid)

    ``ragged=False`` (the default, as in JAX) runs the dense per-phase
    scheduler, ``ragged=True`` the unified ragged one. Given a model, the
    engine builds its decoder with ``PagedLlamaDecoder.from_model`` from
    ``num_blocks``, ``block_size``, ``weight_dtype``, ``kv_quant`` and
    ``device`` (``None``: cuda); a prebuilt decoder keeps its own pool
    and device, and a ``kv_quant`` that contradicts its pool raises.
    ``tp``, ``tp_comm``, ``mesh`` and ``devices`` follow JAX's rules (the
    module docstring). ``tracer``, ``slo``, ``profile_every`` and
    ``profile_seed`` are the telemetry of the module docstring.
    ``cuda_graphs=False`` runs every program eagerly on the card too (for
    comparison with the graphs); on the CPU programs always run
    eagerly."""

    # row-count rungs of the [T, W] schedule; W pads up to the next rung
    RAGGED_WIDTHS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
    # prefill rows per pure-prefill chunk on an idle engine (the default
    # of ``ragged_idle_cap``)
    _RAGGED_IDLE_CAP = 256
    # rows of a grouped dense prefill final (a lone final runs 1 row)
    PREFILL_GROUP = 4
    # capacity of the finished-request ITL reservoir: every test and smoke
    # workload stays exact, an unbounded run stays bounded
    ITL_RESERVOIR_K = 4096

    def __init__(self, model, max_batch_size: int = 8,
                 num_blocks: int = 512, block_size: int = 16,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 weight_dtype: Optional[str] = None, top_k: int = 0,
                 chunk_size: int = 8, seed: int = 0,
                 overlap: bool = True, mesh=None,
                 chunk_schedule: Optional[Sequence[int]] = None,
                 prefix_caching: bool = True,
                 prefill_chunk: Optional[int] = 256,
                 prefill_budget: Optional[int] = None,
                 max_dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 admission: str = "worst_case",
                 max_queue_depth: Optional[int] = None,
                 ragged: bool = False, tp: int = 1,
                 tp_comm: Optional[str] = None,
                 devices: Optional[Sequence] = None,
                 spec_decode: Optional[SpecConfig] = None,
                 lora: Optional[AdapterRegistry] = None, tracer=None,
                 kv_quant: Optional[str] = None,
                 slo=None,
                 profile_every: Optional[int] = None,
                 profile_seed: int = 0,
                 ragged_idle_cap: Optional[int] = None,
                 multi_step: int = 1,
                 cuda_graphs: bool = True, device=None):
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if tp_comm not in (None, "fp32", "int8"):
            raise ValueError(f"tp_comm must be 'fp32' or 'int8', got "
                             f"{tp_comm!r}")
        if tp > 1 and mesh is not None:
            raise ValueError("pass either tp=N (manual shard_map serving) "
                             "or mesh= (GSPMD decoder placement), not both")
        if profile_every is not None and int(profile_every) < 1:
            raise ValueError(f"profile_every must be >= 1, got "
                             f"{profile_every}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got "
                             f"{kv_quant!r}")
        if isinstance(model, _PagedDecoder):
            # a prebuilt decoder (PagedLlamaDecoder or PagedGPTDecoder)
            # keeps its pool, weights and device; the pool arguments here
            # are ignored, as in JAX
            if kv_quant is not None and model.kv_quant != kv_quant:
                raise ValueError(
                    f"ServingEngine(kv_quant={kv_quant!r}) got a prebuilt "
                    f"decoder whose pool was built with kv_quant="
                    f"{model.kv_quant!r}; pass the desired kv_quant to the "
                    f"decoder constructor instead")
            if device is not None and \
                    torch.device(device) != model.device:
                raise ValueError(
                    f"device={device!r} only applies when the engine "
                    f"builds the decoder; the prebuilt decoder lives on "
                    f"{model.device}")
            if devices is not None:
                raise ValueError(
                    "devices= only applies when the engine builds the "
                    "decoder itself; a prebuilt decoder's mesh already "
                    "fixed its device placement")
            if tp > 1 and model._tp != tp:
                raise ValueError(
                    f"ServingEngine(tp={tp}) got a prebuilt decoder with tp "
                    f"degree {model._tp}; build the decoder with the "
                    f"matching mesh (tp_shard_map=True) or drop the engine "
                    f"tp argument")
            if tp_comm is not None and model.tp_comm != tp_comm:
                raise ValueError(
                    f"ServingEngine(tp_comm={tp_comm!r}) got a prebuilt "
                    f"decoder built with tp_comm={model.tp_comm!r}; pass "
                    f"the desired tp_comm to the decoder constructor "
                    f"instead")
            dec = model
        elif isinstance(model, LlamaForCausalLM):
            dec = decoder_from_model(
                model, tp=tp, devices=devices, device=device, mesh=mesh,
                tp_comm=tp_comm, num_blocks=num_blocks,
                block_size=block_size, weight_dtype=weight_dtype,
                kv_quant=kv_quant)
        else:
            raise TypeError(f"ServingEngine needs a LlamaForCausalLM or a "
                            f"prebuilt PagedLlamaDecoder / PagedGPTDecoder, "
                            f"got {type(model).__name__}")
        if admission not in ("worst_case", "optimistic"):
            raise ValueError(
                f"admission must be 'worst_case' or 'optimistic', got "
                f"{admission!r}")
        multi_step = int(multi_step)
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        if multi_step > 1 and spec_decode is not None:
            raise ValueError(
                "multi_step > 1 and spec_decode are mutually exclusive: "
                "speculative verify windows re-plan every step from "
                "collected acceptance, which a fused k-step program "
                "cannot observe mid-window")
        if lora is not None and not isinstance(lora, AdapterRegistry):
            raise TypeError(f"lora must be an AdapterRegistry, got "
                            f"{type(lora).__name__}")
        if spec_decode is not None and not isinstance(spec_decode,
                                                      SpecConfig):
            raise TypeError(f"spec_decode must be a SpecConfig, got "
                            f"{type(spec_decode).__name__}")
        self.dec = dec
        self.device = dec.device
        # the decoder's tp degree and comm mode (JAX: a GSPMD mesh
        # decoder's tp is 1)
        self.tp = dec._tp
        self.tp_comm = dec.tp_comm
        # the pool's quantization (None: dense planes), for stats()
        self.kv_quant = dec.cache.kv_quant
        # each of these families is a ragged program
        self.multi_step = multi_step
        self.spec = spec_decode
        self.lora = lora
        self.ragged = (bool(ragged) or multi_step > 1 or self.tp > 1
                       or spec_decode is not None or lora is not None)
        self._drafter = spec_decode.make_drafter() if spec_decode else None
        if lora is not None:
            # the adapter plane's placement comes from the canonical table
            # (replicated) like every other sharded serving array
            lora.bind(dec, sharding=SpecLayout().spec("lora_pool")
                      if self.tp > 1 else None)
        self.max_b = int(max_batch_size)
        self.top_k = int(top_k)
        self.buckets = tuple(sorted(int(b) for b in prompt_buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"prompt_buckets must be positive, got "
                             f"{prompt_buckets!r}")
        if chunk_schedule:
            self.chunks = tuple(sorted({max(1, int(c))
                                        for c in chunk_schedule}))
        else:
            self.chunks = (max(1, int(chunk_size)),)
        self.overlap = bool(overlap)
        # dense path: mid chunks of exactly prefill_chunk tokens (None:
        # every prompt is one final); the per-step prefill token cap
        # while decodes run
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        self.prefill_budget = max(1, int(prefill_budget)) \
            if prefill_budget else (self.prefill_chunk or 0)
        # the width of a resume's no-sample chunks: the mid chunk when
        # chunked prefill is on, else a 64-wide rung of its own
        self._recompute_chunk = self.prefill_chunk or 64
        # ragged path: prefill tokens folded into one chunk while
        # decodes run
        self._ragged_cap = (self.prefill_budget or self.prefill_chunk
                            or self._recompute_chunk)
        if ragged_idle_cap is not None and int(ragged_idle_cap) < 1:
            raise ValueError(f"ragged_idle_cap must be >= 1, got "
                             f"{ragged_idle_cap}")
        self._ragged_idle_cap = (int(ragged_idle_cap)
                                 if ragged_idle_cap is not None
                                 else self._RAGGED_IDLE_CAP)
        self._force_chunk: Optional[int] = None
        # measured seconds per chunk of each rung (warmup), read by
        # _pick_chunk; empty: the zero-waste heuristic
        self._chunk_cost: Dict[int, float] = {}
        self.prefix_caching = bool(prefix_caching)
        # faults: bounded retry of every dispatch and collection, the
        # admission policy, the shedding cap, the chaos hook
        self.max_dispatch_retries = max(0, int(max_dispatch_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.admission = admission
        self.max_queue_depth = (int(max_queue_depth)
                                if max_queue_depth is not None else None)
        self.chaos = None
        # every decoder of the port has the no-sample programs a resume
        # needs; tests clear this to take the no-recompute path
        self._can_recompute = True
        self._debug_pool = os.environ.get(
            "PADDLE_TPU_POOL_DEBUG", "") not in ("", "0")
        # writers' splice-pending blocks: block -> (writer, its
        # prefill_sent that covers the block)
        self._pending_writes: Dict[int, tuple] = {}
        self._key = prng.PRNGKey(int(seed))
        cache = dec.cache
        # the decoder (and its index) outlives engines: start clean
        cache.clear_prefix_cache()
        cache.reset_prefix_stats()
        # one scratch page: padding rows write here and read nothing (a
        # decoder reused across engines keeps its scratch page)
        if -1 not in cache._tables:
            cache.allocate(-1, 1)
        self._scratch_block = cache._tables[-1][0]
        self._scratch_slot = self._scratch_block * cache.block_size
        # prefix-table width of a final (a prompt is at most the largest
        # bucket), and the power-of-two widths of mid chunks, whose
        # prefix is only the chunks before them; resumes run mid chunks
        # past the largest bucket, so the ladder goes on doubling to the
        # longest table one sequence can hold
        self._prefix_pages = -(-self.buckets[-1] // cache.block_size)
        self._prefix_page_buckets = []
        p = 1
        while p < self._prefix_pages:
            self._prefix_page_buckets.append(p)
            p *= 2
        self._prefix_page_buckets.append(self._prefix_pages)
        cap_pages = min(dec.max_pages, max(1, cache.num_blocks - 1))
        while p < cap_pages and self._prefix_page_buckets[-1] < cap_pages:
            if p > self._prefix_page_buckets[-1]:
                self._prefix_page_buckets.append(min(p, cap_pages))
            p *= 2
        if self._prefix_page_buckets[-1] < cap_pages:
            self._prefix_page_buckets.append(cap_pages)

        self._slots: List[Optional[Request]] = [None] * self.max_b
        self._last_tok = np.zeros(self.max_b, np.int32)
        self._queue: deque = deque()
        self._done: Dict[int, Request] = {}
        self._ids = itertools.count()
        self._mask_serials = itertools.count(1)
        # dispatched, uncollected chunks in device order: "prefill" and
        # "decode" entries (dense), "ragged" entries
        self._inflight: deque = deque()
        # dense: slots (re)filled since the last decode dispatch, whose
        # first token comes from the host
        self._fresh_slots: set = set()
        self._closed = False
        # dense decode: the newest decode chunk's tokens [mb, T], written
        # inside its program, which the next chunk's merge reads
        self._carry = torch.zeros((self.max_b, max(self.chunks)),
                                  dtype=torch.int32, device=self.device)
        # the rich programs' seen / allowed planes, made at first use
        self._masks: Optional[_MaskPlanes] = None
        self.compile_watch = CompileWatch()
        self.programs = ProgramSet(self.device, self.compile_watch,
                                   graphs=cuda_graphs, devices=dec.devices)
        info = {"decoder": type(dec).__name__, "tp": self.tp,
                "tp_comm": self.tp_comm,
                "kv_quant": dec.kv_quant or "none",
                "weight_dtype": dec.weight_dtype or "none"}
        fams = [("prefill", self._final_program),
                ("prefill_prefix", self._final_program),
                ("decode", self._decode_program),
                ("prefill_mid0", self._mid_program),
                ("prefill_mid", self._mid_program)]
        if self.ragged:
            # JAX's families (serving.py:1535-1546): the chunk, the
            # multi-step window and their lora twins; JAX's _rich twin
            # of each is its rich=True key here, as in every family
            for ms, lo in sorted({(ms, lo)
                                  for ms in (False, self.multi_step > 1)
                                  for lo in (False, lora is not None)}):
                fams.append((self._ragged_family(ms, lo),
                             functools.partial(self._ragged_program,
                                               ms=ms, lora=lo)))
        if self.spec is not None:
            fams.append(("spec", self._spec_program))
            if lora is not None:
                fams.append(("spec_lora", functools.partial(
                    self._spec_program, lora=True)))
        for fam, fn in fams:
            self.programs.register(
                fam, fn, preserve=(self._carry,) if fam == "decode" else (),
                **info)
        self.decode_steps = 0
        self.generated_tokens = 0
        self.device_dispatches = 0
        self.decode_slot_steps = 0
        self.decode_useful_tokens = 0
        self.masked_decode_columns = 0
        # finished requests' ITL samples (stats(); reset by
        # clear_finished with the requests it sampled)
        self._itl_res = Reservoir(self.ITL_RESERVOIR_K)
        # robustness counters (stats(); reset by clear_finished)
        self.preemptions = 0
        self.recompute_tokens = 0
        self.aborted = 0
        self.failed = 0
        self.deadline_misses = 0
        self.shed_requests = 0
        self.retries = 0
        self.dispatch_exhaustions = 0
        # spec decode, lora and multi-step counters (stats())
        self._reset_family_counters()
        # wall seconds at the dense path's host call sites: prefill
        # dispatch and collection, waits on decode tokens, and decode
        # scheduling and dispatch
        self.time_prefill_s = 0.0
        self.time_stall_s = 0.0
        self.time_host_s = 0.0
        # sampled dispatch attribution: every profile_every-th dispatch
        # (seeded start phase, so identical runs sample identical
        # dispatches); off by default, as its fences cost a sync
        self._prof_n = int(profile_every) if profile_every else 0
        self._prof_metrics = None        # made at first use, untraced
        self._prof_countdown = 0
        if self._prof_n:
            rng = np.random.RandomState(int(profile_seed))
            self._prof_countdown = 1 + int(rng.randint(self._prof_n))
        self._prof_mark = time.perf_counter()
        self.profiled_dispatches = 0
        # declared SLOs: a monitor as given, or one over the policies
        if isinstance(slo, SLOMonitor):
            self._slo = slo
        else:
            pols = SLOMonitor.coerce_policies(slo)
            self._slo = SLOMonitor(pols) if pols else None
        self._slo_violating: set = set()
        self.set_telemetry(tracer)

    def _reset_family_counters(self):
        """The spec decode, lora and multi-step counters of ``stats()``
        (the multi_step gauge is configuration and stays)."""
        self.drafted_tokens = 0
        self.accepted_draft_tokens = 0
        self.spec_rollbacks = 0
        self.draft_acceptance_ema = 0.0
        self.lora_dispatches = 0
        self.lora_rows = 0
        self.ms_windows = 0
        self.ms_frozen_token_waste = 0
        if self.lora is not None:
            self.lora.reset_stats()

    # -- telemetry -----------------------------------------------------------
    def set_telemetry(self, tracer, replica_id: int = 0):
        """Attach (a ``Tracer``) or detach (None) telemetry. The tracer
        is threaded into the KV pool, the adapter registry and the compile
        watch, so their records ride the same flight recorder;
        ``replica_id`` is the pid every record of this engine carries
        (the fleet Router sets it to the replica index)."""
        self.tracer = tracer
        self.replica_id = int(replica_id)
        cache = self.dec.cache
        cache.tracer = tracer
        cache.trace_pid = self.replica_id
        if self.lora is not None:
            self.lora.tracer = tracer
            self.lora.trace_pid = self.replica_id
        self.compile_watch.bind(tracer, pid=self.replica_id)

    def _profile_metrics(self) -> MetricsRegistry:
        """The registry the attribution histograms feed: the tracer's,
        or the engine's own when no tracer is attached."""
        if self.tracer is not None:
            return self.tracer.metrics
        if self._prof_metrics is None:
            self._prof_metrics = MetricsRegistry()
        return self._prof_metrics

    def _prof_due(self) -> bool:
        """Every ``profile_every``-th dispatch, from the seeded phase."""
        if not self._prof_n:
            return False
        self._prof_countdown -= 1
        if self._prof_countdown > 0:
            return False
        self._prof_countdown = self._prof_n
        return True

    def _prof_record(self, kind: str, family: str, host_s: float,
                     queue_s: float, execute_s: float):
        """One sampled dispatch: host-schedule, dispatch-queue and
        device-execute seconds, overall and device-execute per program
        family."""
        m = self._profile_metrics()
        m.histogram("profile.host_schedule_s").observe(max(0.0, host_s))
        m.histogram("profile.dispatch_queue_s").observe(max(0.0, queue_s))
        m.histogram("profile.device_execute_s").observe(
            max(0.0, execute_s))
        m.histogram(f"profile.device_execute_s.{family}").observe(
            max(0.0, execute_s))
        self.profiled_dispatches += 1
        if self.tracer is not None:
            self.tracer.event(
                "profile_sample", pid=self.replica_id, family=family,
                kind=kind, host_s=round(host_s, 6),
                queue_s=round(queue_s, 6), execute_s=round(execute_s, 6))

    def _slo_attrs(self, req: Request) -> dict:
        return {"adapter_id": req.sampling.adapter_id,
                "priority": req.sampling.priority}

    def _mark_first_token(self, req: Request, now: float):
        """First-token bookkeeping of every collection path, first life
        only: a resume is not a first token, so neither ``ttft_s`` nor
        the SLO windows see it twice."""
        if req.t_first_token is None:
            req.t_first_token = now
            if self._slo is not None:
                self._slo.observe("ttft", now - req.t_submit,
                                  self._slo_attrs(req), now=now)
        req.t_last_emit = now

    def _trace_running(self, req: Request, now: float):
        """Close the life's prefill span at its running transition
        (call sites check the tracer)."""
        if req.trace_id is None:
            return
        t0 = req.t_life or req.t_admit or now
        self.tracer.span(
            "prefill", req.trace_id, t0, now, pid=self.replica_id,
            epoch=req.epoch, n_cached=int(req.n_cached),
            recompute=bool(req.resume))
        req.t_run = now

    def _trace_life_end(self, req: Request, reason: str, now: float):
        """Close the phase span the life was in (decode when running,
        an interrupted prefill when prefilling, queued when it never had
        a slot, and any splice wait) and reset the life's markers (call
        sites check the tracer)."""
        if req.trace_id is None:
            return
        tr = self.tracer
        if req.t_run is not None:
            tr.span("decode", req.trace_id, req.t_run, now,
                    pid=self.replica_id, epoch=req.epoch, reason=reason,
                    tokens=len(req.out_tokens))
        elif req.t_life:
            tr.span("prefill", req.trace_id, req.t_life, now,
                    pid=self.replica_id, epoch=req.epoch, reason=reason,
                    interrupted=True)
        elif req.t_queued:
            tr.span("queued", req.trace_id, req.t_queued, now,
                    pid=self.replica_id, reason=reason)
        if req.t_wait is not None:
            tr.span("splice_wait", req.trace_id, req.t_wait, now,
                    pid=self.replica_id, reason=reason)
        req.t_run = None
        req.t_life = 0.0
        req.t_wait = None

    def _sample_counter_tracks(self):
        """One sample per scheduler gauge per step (tracer attached):
        host state only."""
        tr = self.tracer
        pid = self.replica_id
        cache = self.dec.cache
        tr.counter("running_slots",
                   sum(1 for r in self._slots
                       if r is not None and r.state == "running"), pid)
        tr.counter("queue_depth", len(self._queue), pid)
        tr.counter("inflight_chunks", len(self._inflight), pid)
        tr.counter("free_blocks", cache.free_blocks, pid)
        tr.counter("cached_blocks", cache.cached_blocks, pid)
        if self.spec is not None:
            tr.counter("acceptance_ema", self.draft_acceptance_ema, pid)
        if self.lora is not None:
            tr.counter("active_adapters", self.lora.active_count(), pid)

    # -- the key stream ------------------------------------------------------
    def _next_key(self) -> np.ndarray:
        """JAX's ``_next_key``: split the engine key, keep the first half,
        hand out the second."""
        self._key, k = prng.split(self._key)
        return k

    @staticmethod
    def _key_operand(keys: np.ndarray) -> np.ndarray:
        """uint32 keys as the int32 operand a program takes."""
        return np.ascontiguousarray(keys, np.uint32).view(np.int32)

    def _mask_planes(self) -> _MaskPlanes:
        if self._masks is None:
            rows = self.max_b
            if self.ragged:
                rows = max([rows] + [max(self.reachable_ragged_widths(T))
                                     for T in set(self.chunks) | {1}])
            self._masks = _MaskPlanes(rows, self.dec.cfg.vocab_size,
                                      self.device)
        return self._masks

    # -- faults --------------------------------------------------------------
    def _device_call(self, kind: str, fn, *args):
        """Every dispatch (``kind`` "dispatch:*") and collection
        ("collect:*") goes through here: the chaos hook, then the call,
        retried on an exception up to ``max_dispatch_retries`` times with
        the same arguments (the same operands and keys, so a successful
        retry is token-identical) after an exponential backoff. Pool
        exhaustion passes through (preemption handles it); an exception
        that outlives the retries becomes ``_DispatchFailed``, which the
        call site turns into failed requests. The chaos hook raises
        before the call, so an injected fault is always safe to
        retry."""
        attempt = 0
        dispatch = kind.startswith("dispatch:")
        # sampled attribution, decided once per call (not per retry) so
        # the seeded cadence does not depend on faults
        prof = dispatch and self._prof_due()
        while True:
            try:
                if self.chaos is not None:
                    self.chaos.before_call(self, kind)
                if prof:
                    out = self._profiled_call(kind, fn, args)
                    prof = False
                else:
                    out = fn(*args)
                if dispatch:
                    self.device_dispatches += 1
                if self._prof_n:
                    self._prof_mark = time.perf_counter()
                return out
            except KVCacheExhausted:
                raise
            except Exception as e:          # noqa: BLE001 -- the fault wall
                if attempt >= self.max_dispatch_retries:
                    self.dispatch_exhaustions += 1
                    if self.tracer is not None:
                        self.tracer.event(
                            "dispatch_exhausted", pid=self.replica_id,
                            kind=kind, error=type(e).__name__)
                    raise _DispatchFailed(kind, e) from e
                attempt += 1
                self.retries += 1
                if self.tracer is not None:
                    self.tracer.event("retry", pid=self.replica_id,
                                      kind=kind, attempt=attempt)
                if self.retry_backoff_s > 0:
                    time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _profiled_call(self, kind: str, fn, args):
        """One sampled dispatch: the host time since the previous device
        call ended, a ``torch.cuda.synchronize()`` draining the work
        queued before it (timed on the host), and the program itself
        between two CUDA events recorded around its launch (around the
        graph's replay), waited on here. On the CPU the program's time
        is the host wall of its eager call. Values are not touched, so
        tokens are the same sampled or not."""
        tq0 = time.perf_counter()
        host_s = tq0 - self._prof_mark
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        tq1 = time.perf_counter()
        family = args[0]            # a dispatch is programs.run(family, ...)
        if cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            out = fn(*args, events=events)
            events[1].synchronize()
            execute_s = events[0].elapsed_time(events[1]) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            execute_s = time.perf_counter() - t0
        self._prof_record(kind, family, host_s, tq1 - tq0, execute_s)
        return out

    def cancel(self, req_id: int) -> bool:
        """Abort a request in any live state: queued, prefilling (its
        allocation unwound: splice-pending hashes dropped, dependent
        readers restarted, blocks freed) or running (partial tokens
        kept; pages freed once no chunk in flight uses them). False if
        the request is already terminal; KeyError for an unknown id."""
        req = self._find_request(req_id)
        if req is None:
            raise KeyError(f"unknown req_id {req_id}")
        if req.state in ("done", "aborted", "failed"):
            return False
        self._abort_request(req, "cancelled")
        return True

    def _find_request(self, req_id: int) -> Optional[Request]:
        if req_id in self._done:
            return self._done[req_id]
        for r in self._slots:
            if r is not None and r.req_id == req_id:
                return r
        for r in self._queue:
            if r.req_id == req_id:
                return r
        return None

    def _enforce_deadlines(self):
        """Abort every live request past its deadline (partial tokens
        kept)."""
        now = time.perf_counter()
        expired = [r for r in list(self._queue)
                   + [s for s in self._slots if s is not None]
                   if r.deadline_at is not None and now > r.deadline_at]
        for req in expired:
            self.deadline_misses += 1
            self._abort_request(
                req, f"deadline exceeded "
                     f"({req.sampling.deadline_s:.3f}s budget)")

    def _estimate_completion_s(self, sp: SamplingParams
                               ) -> Optional[float]:
        """Backlog tokens (queued and running remainders plus the
        candidate's budget) over the engine's measured token rate; None
        until the engine has a rate, so a cold engine never sheds on
        deadline math."""
        busy = self.time_prefill_s + self.time_stall_s + self.time_host_s
        if self.generated_tokens < 8 or busy <= 0:
            return None
        rate = self.generated_tokens / busy
        backlog = sum(r.sampling.max_new_tokens - len(r.out_tokens)
                      for r in self._queue)
        backlog += sum(r.sampling.max_new_tokens - len(r.out_tokens)
                       for r in self._slots if r is not None)
        return (backlog + sp.max_new_tokens) / rate

    def _pick_victim(self, exclude=()) -> Optional[Request]:
        """The preemption victim: lowest priority first, newest req_id on
        ties, so the oldest highest-priority request always progresses.
        Running requests first (they free the most), prefilling ones
        only when none runs."""
        if not self._can_recompute:
            return None
        for states in (("running",), ("prefilling",)):
            cands = [r for r in self._slots
                     if r is not None and r.state in states
                     and r not in exclude]
            if cands:
                return max(cands, key=lambda r: (-r.sampling.priority,
                                                 r.req_id))
        return None

    def _preempt(self, victim: Request):
        """Evict ``victim`` from its slot, free its blocks now (a chunk in
        flight that touches them was dispatched earlier and runs first
        in stream order; collection drops its tokens by epoch) and put
        it back in the queue. A running victim resumes by prefilling
        prompt ++ history through the no-sample programs; a prefilling
        one restarts its prefill."""
        self.preemptions += 1
        if self.tracer is not None and victim.trace_id is not None:
            self.tracer.event(
                "preempt", trace=victim.trace_id, pid=self.replica_id,
                state=victim.state, tokens=len(victim.out_tokens),
                priority=victim.sampling.priority)
        self._evict_to_queue(victim)
        self._requeue_front([victim])

    def _evict_to_queue(self, req: Request):
        """Move a slotted request back to a fresh queued life: bump the
        epoch, vacate the slot, unwind or free the allocation (while its
        coverage is still intact, so met reader deps prune first), and
        reset the per-life prefill progress. The free is immediate: the
        request may be admitted again before the next collection. The
        caller requeues."""
        if self.tracer is not None and req.trace_id is not None:
            now = time.perf_counter()
            self._trace_life_end(req, "evict", now)
            req.t_queued = now          # the requeued life's queued span
        req.epoch += 1
        si = req.slot
        if si is not None:
            self._slots[si] = None
            self._fresh_slots.discard(si)
        req.slot = None
        # the adapter pin goes with the slot; readmission acquires again
        self._lora_release(req)
        if req.state == "prefilling":
            self._unwind_alloc(req, immediate=True)
        else:
            self._restart_dependent_readers(req)
            self.dec.cache.free(req.req_id)
        req.resume = bool(req.out_tokens)
        req.state = "queued"
        req.planned = len(req.out_tokens)
        req.n_cached = 0
        req.prefill_sent = 0
        req.deps = []
        req.pending_blocks = []
        req.ctx = None

    def _extend_with_preempt(self, req: Request, exclude=()) -> int:
        """``cache.extend`` that preempts the policy victim on exhaustion
        and tries again; when ``req`` itself is the victim the exhaustion
        propagates and the caller fails ``req``."""
        while True:
            try:
                return self.dec.cache.extend(req.req_id)
            except KVCacheExhausted:
                victim = self._pick_victim(exclude=tuple(exclude))
                if victim is None or victim is req:
                    raise
                self._preempt(victim)

    def _requeue_front(self, reqs: Sequence[Request]):
        """Put evicted requests back in the queue in req_id order: ahead
        of every later arrival, FIFO among themselves."""
        if not reqs:
            return
        merged = sorted(list(self._queue) + list(reqs),
                        key=lambda r: r.req_id)
        self._queue.clear()
        self._queue.extend(merged)

    def _unwind_alloc(self, req: Request, immediate: bool = False):
        """Unwind a prefilling request's allocation: drop the hashes of
        its own full blocks whose rows were never dispatched, drop its
        splice-pending entries, restart the readers that spliced blocks
        it will now never write, and free the blocks (now, or after the
        newest chunk in flight)."""
        cache = self.dec.cache
        bs = cache.block_size
        covered = req.n_cached + req.prefill_sent
        try:
            table = cache.seq_blocks(req.req_id)
        except KeyError:
            table = None
        if table is not None:
            own_uncovered = [
                table[j]
                for j in range(req.n_cached // bs,
                               len(req.prefill_tokens) // bs)
                if (j + 1) * bs > covered and j < len(table)]
            cache.unregister_block_hashes(own_uncovered)
        self._clear_pending_writes(req)
        self._restart_dependent_readers(req)
        if table is not None:
            if immediate or not self._inflight:
                cache.free(req.req_id)
            else:
                self._inflight[-1]["free_after"].append(req.req_id)

    def _restart_dependent_readers(self, writer: Request):
        """Settle every splice dependency on ``writer`` against its
        current coverage before preemption or an unwind resets it: met
        ones are pruned (they name rows already dispatched), and readers
        still waiting restart from scratch."""
        for r in self._slots:
            if r is not None and r.deps:
                r.deps = [(w, need) for w, need in r.deps
                          if not (w is writer
                                  and writer.prefill_sent >= need)]
        readers = [r for r in self._slots
                   if r is not None and r.state == "prefilling"
                   and any(w is writer for w, need in r.deps)]
        restarted = []
        for r in readers:
            # the recursion below may already have restarted r
            if r.state != "prefilling":
                continue
            self._evict_to_queue(r)
            restarted.append(r)
        self._requeue_front(restarted)

    def _abort_request(self, req: Request, msg: str):
        self.aborted += 1
        self._finalize(req, "aborted", msg)

    def _fail_request(self, req: Request, msg: str):
        self.failed += 1
        self._finalize(req, "failed", msg)

    def _finalize(self, req: Request, state: str, msg: str):
        """Move a live request to a terminal fault state, unwinding the
        stage it was in; partial tokens are kept and ``error`` says
        why."""
        if req.state == "queued":
            try:
                self._queue.remove(req)
            except ValueError:
                pass
        else:
            si = req.slot
            if si is not None:
                self._slots[si] = None
                self._fresh_slots.discard(si)
            req.slot = None
            req.epoch += 1     # chunks in flight drop its tokens
            self._lora_release(req)
            if req.state == "prefilling":
                self._unwind_alloc(req)
            elif req.req_id in self.dec.cache._tables:
                # running: freed after the newest chunk in flight, which
                # was dispatched assuming it continues (as _retire)
                if self._inflight:
                    self._inflight[-1]["free_after"].append(req.req_id)
                else:
                    self.dec.cache.free(req.req_id)
        req.state = state
        req.error = msg
        req.t_done = time.perf_counter()
        if self.tracer is not None and req.trace_id is not None:
            self._trace_life_end(req, state, req.t_done)
            if not req.trace_keep_open:
                self.tracer.end_request(
                    req.trace_id, state, replica=self.replica_id,
                    error=msg)
        self._done[req.req_id] = req

    def debug_dump(self) -> str:
        """A readable snapshot of the scheduler: requests by slot, queue
        and pipeline depth, the robustness counters, pool occupancy."""
        cache = self.dec.cache
        lines = ["serving engine state:"]
        for si, r in enumerate(self._slots):
            if r is None:
                lines.append(f"  slot {si}: idle")
            else:
                lines.append(
                    f"  slot {si}: req {r.req_id} state={r.state} "
                    f"out={len(r.out_tokens)}/{r.sampling.max_new_tokens}"
                    f" planned={r.planned} prefill={r.prefill_sent}/"
                    f"{r.suffix_len} epoch={r.epoch} resume={r.resume}")
        lines.append(f"  queue depth={len(self._queue)} ids="
                     f"{[r.req_id for r in self._queue][:16]}")
        lines.append(f"  inflight={len(self._inflight)} "
                     f"finished={len(self._done)}")
        lines.append(
            f"  counters: preemptions={self.preemptions} "
            f"retries={self.retries} aborted={self.aborted} "
            f"failed={self.failed} deadline_misses={self.deadline_misses}"
            f" shed={self.shed_requests} "
            f"recompute_tokens={self.recompute_tokens}")
        lines.append(
            f"  cache: free_blocks={cache.free_blocks} "
            f"cached_blocks={cache.cached_blocks} "
            f"referenced={len(cache._ref)} of {cache.num_blocks}")
        return "\n".join(lines) + "\n"

    # -- requests ------------------------------------------------------------
    def _validate_new_request(self, prompt, sp: SamplingParams):
        """Prompt intake and the checks every request passes on both
        paths: the bucket bound, the adapter, the pool (with the adapter's
        pages) and table geometry, the vocab range and the allowed-token
        mask. Returns (prompt, allowed mask or None)."""
        prompt = _normalize_prompt(prompt)
        if int(sp.max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{sp.max_new_tokens}")
        _bucket_for(int(prompt.size), self.buckets)   # validates length
        cache = self.dec.cache
        total = int(prompt.size) + int(sp.max_new_tokens)
        need = -(-total // cache.block_size)
        # a tenant's request needs its adapter's pages from the same pool
        lora_pages = 0
        if sp.adapter_id is not None:
            if self.lora is None:
                raise ValueError(
                    f"adapter_id={sp.adapter_id!r} but the engine has no "
                    f"AdapterRegistry (pass lora= to ServingEngine)")
            if not self.lora.is_registered(sp.adapter_id):
                raise KeyError(f"unknown adapter {sp.adapter_id!r}: "
                               f"register it before submitting requests")
            lora_pages = self.lora.n_pages()
        if need + lora_pages > cache.num_blocks - 1:   # -1: the scratch
            raise ValueError(
                f"request needs {need} KV pages"
                + (f" + {lora_pages} adapter pages" if lora_pages else "")
                + f" but the pool only has {cache.num_blocks - 1}; shrink "
                f"max_new_tokens/prompt or grow num_blocks")
        if need > self.dec.max_pages:
            raise ValueError(
                f"request needs {need} KV pages but a block table holds "
                f"{self.dec.max_pages}")
        vocab = self.dec.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt ids must lie in [0, {vocab})")
        allowed = None
        if sp.allowed_tokens is not None:
            allowed = self._normalize_allowed(sp.allowed_tokens, vocab)
        return prompt, allowed

    @staticmethod
    def _normalize_allowed(allowed_tokens, vocab: int) -> np.ndarray:
        """allowed_tokens (a bool mask of length vocab, or a sequence of
        token ids) as a [vocab] bool mask; empty masks, out-of-range ids
        and integer 0/1 vectors of length vocab are refused."""
        arr = np.asarray(allowed_tokens)
        if arr.dtype == bool:
            if arr.shape != (vocab,):
                raise ValueError(
                    f"allowed_tokens bool mask must have shape "
                    f"({vocab},), got {arr.shape}")
            mask = arr.copy()
        else:
            if (arr.ndim == 1 and arr.size == vocab and vocab > 2
                    and np.isin(arr, (0, 1)).all()):
                raise ValueError(
                    f"allowed_tokens is a length-{vocab} integer 0/1 "
                    f"vector -- ambiguous between a mask and an id "
                    f"list; pass a bool mask (astype(bool)) or a list "
                    f"of allowed token ids")
            ids = arr.astype(np.int64).reshape(-1)
            if ids.size and (ids.min() < 0 or ids.max() >= vocab):
                raise ValueError(
                    f"allowed_tokens ids out of range [0, {vocab})")
            mask = np.zeros(vocab, bool)
            mask[ids] = True
        if not mask.any():
            raise ValueError("allowed_tokens permits no token -- "
                             "nothing could ever be sampled")
        return mask

    # -- adapters ------------------------------------------------------------
    def _lora_acquire(self, req: Request):
        """Pin the request's adapter at admission; raises
        ``KVCacheExhausted`` when its pages do not fit."""
        if req.sampling.adapter_id is None or req.lora_held:
            return
        self.lora.acquire(req.sampling.adapter_id)
        req.lora_held = True

    def _lora_release(self, req: Request):
        """Drop the request's pin whenever it leaves its slot (retire,
        abort or fail, preemption or restart)."""
        if req.lora_held:
            self.lora.release(req.sampling.adapter_id)
            req.lora_held = False

    def _lora_tables_operand(self, sched) -> np.ndarray:
        """[max_b + 1, n_pages] adapter pages per engine slot for one
        dispatch; base slots and the scratch row read the scratch
        block, the all-zero null adapter."""
        tables = np.full((self.max_b + 1, self.lora.n_pages()),
                         self._scratch_block, np.int32)
        for req, _ in sched.values():
            aid = req.sampling.adapter_id
            if aid is not None and req.slot is not None:
                tables[req.slot] = self.lora.resident_blocks(aid)
        return tables

    def _debug_lora_check(self):
        """The registry's use counts against the slots, then its page
        invariants."""
        expected: Dict[object, int] = {}
        for r in self._slots:
            if r is not None and r.lora_held:
                aid = r.sampling.adapter_id
                expected[aid] = expected.get(aid, 0) + 1
        self.lora.debug_check(expected_use=expected)

    def _use_lora(self, sched, rows_of) -> bool:
        """Whether a dispatch runs a lora twin (some scheduled request
        has an adapter), counting its adapter rows."""
        if self.lora is None or not any(
                req.sampling.adapter_id is not None
                for req, _ in sched.values()):
            return False
        self.lora_dispatches += 1
        self.lora_rows += sum(len(rows_of.get(rid, []))
                              for rid, (req, _) in sched.items()
                              if req.sampling.adapter_id is not None)
        return True

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None
                    ) -> int:
        """Queue a prompt ([len] ids). Returns its request id. Raises
        ``EngineOverloaded`` when shedding refuses it."""
        if self._closed:
            raise RuntimeError("engine is closed")
        sp = sampling or SamplingParams()
        prompt, allowed = self._validate_new_request(prompt, sp)
        if self.max_queue_depth is not None and \
                len(self._queue) >= self.max_queue_depth:
            self.shed_requests += 1
            if self.tracer is not None:
                self.tracer.event("shed", pid=self.replica_id,
                                  reason="queue_depth")
            raise EngineOverloaded(
                f"queue depth {len(self._queue)} at the "
                f"max_queue_depth={self.max_queue_depth} cap")
        if sp.deadline_s is not None:
            est = self._estimate_completion_s(sp)
            if est is not None and est > sp.deadline_s:
                self.shed_requests += 1
                if self.tracer is not None:
                    self.tracer.event("shed", pid=self.replica_id,
                                      reason="deadline_estimate")
                raise EngineOverloaded(
                    f"estimated completion {est:.3f}s exceeds the "
                    f"{sp.deadline_s:.3f}s deadline "
                    f"(backlog {len(self._queue)} queued)")
        rid = next(self._ids)
        req = Request(rid, prompt, sp, t_submit=time.perf_counter())
        if allowed is not None:
            req.allowed_mask = allowed
            req.allowed_serial = next(self._mask_serials)
        req.t_queued = req.t_submit
        if self.tracer is not None:
            req.trace_id = self.tracer.begin_request(
                rid, tenant=sp.adapter_id, replica=self.replica_id,
                prompt_len=int(prompt.size),
                max_new_tokens=sp.max_new_tokens)
        self._queue.append(req)
        return rid

    def adopt_request(self, prompt, sampling: Optional[SamplingParams]
                      = None, out_tokens: Sequence[int] = (),
                      t_submit: Optional[float] = None,
                      trace_id: Optional[int] = None) -> int:
        """Admit a request that ran, in part, on another engine (the
        fleet Router's migration). The generated history re-enters the
        pool through the preemption-recompute path (``resume``): prompt
        ++ out_tokens[:-1] is prefilled by the no-sample programs, no key
        is drawn, and decode goes on from out_tokens[-1], so greedy
        streams are token-identical across the move. Shedding is
        bypassed (the fleet admitted the request once already); the
        request checks still apply. ``t_submit`` keeps the original
        submission time, so a deadline keeps its meaning. A history that
        already meets the stop condition completes at once. ``trace_id``
        continues the request's telemetry span (None opens one when a
        tracer is attached)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        sp = sampling or SamplingParams()
        prompt, allowed = self._validate_new_request(prompt, sp)
        rid = next(self._ids)
        req = Request(rid, prompt, sp,
                      t_submit=(time.perf_counter() if t_submit is None
                                else float(t_submit)))
        if allowed is not None:
            req.allowed_mask = allowed
            req.allowed_serial = next(self._mask_serials)
        req.t_queued = time.perf_counter()
        if self.tracer is not None:
            req.trace_id = (int(trace_id) if trace_id is not None
                            else self.tracer.begin_request(
                                rid, tenant=sp.adapter_id,
                                replica=self.replica_id,
                                prompt_len=int(prompt.size)))
            self.tracer.event(
                "adopt", trace=req.trace_id, pid=self.replica_id,
                history=len(out_tokens), req_id=rid)
        toks = [int(t) for t in out_tokens]
        if toks and not self._can_recompute:
            # without the no-sample programs the history cannot re-enter
            # the pool without drawing keys: prefill the prompt again
            toks = []
        req.out_tokens = toks
        if toks and (len(toks) >= sp.max_new_tokens
                     or (sp.eos_token_id is not None
                         and toks[-1] == sp.eos_token_id)):
            # the history already finished the request: a resume would
            # schedule one decode row past the budget before retiring
            req.out_tokens = toks[:sp.max_new_tokens]
            req.state = "done"
            req.t_done = time.perf_counter()
            if self.tracer is not None:
                self.tracer.end_request(
                    req.trace_id, "done", replica=self.replica_id,
                    tokens=len(req.out_tokens))
            self._done[rid] = req
            return rid
        req.resume = bool(toks)
        req.planned = len(toks)
        self._queue.append(req)
        return rid

    def result(self, req_id: int) -> np.ndarray:
        """Generated tokens (prompt excluded) of a terminal request; for
        an aborted or failed one, the tokens made before the fault."""
        return np.asarray(self._done[req_id].out_tokens, np.int32)

    def request(self, req_id: int) -> Request:
        """The terminal request record (state done, aborted or failed;
        error says why for the fault states)."""
        return self._done[req_id]

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._inflight)
                or any(r is not None for r in self._slots))

    # -- scheduler -----------------------------------------------------------
    def _admit(self):
        """Claim free slots for queued requests, FIFO. A resume prefills
        prompt ++ history[:-1]. The reservation is the worst case
        (prompt + max_new_tokens) or, optimistic, the prefill plus one
        decode slot, net of the blocks a prefix splice reuses. With
        prefix caching the capacity check happens inside
        ``allocate_with_prefix`` before any mutation, so a refusal
        leaves the pool untouched; a spliced block that a writer has not
        dispatched yet becomes a dependency (``_deps_ready``), and the
        request's own full prefill blocks become splice-pending until
        its dispatches cover them."""
        cache = self.dec.cache
        for si in range(self.max_b):
            if self._slots[si] is not None:
                continue
            if not self._queue:
                break
            req = self._queue[0]
            if req.resume and req.out_tokens:
                toks = np.concatenate(
                    [req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
            else:
                toks = req.prompt
            if self.admission == "optimistic":
                total = int(len(toks)) + 1
            else:
                total = int(req.prompt.size) + req.sampling.max_new_tokens
            # the adapter first: its pages come from the pool the KV
            # allocation below draws on; an adapter that does not fit
            # waits at the head of the queue like a KV refusal
            try:
                self._lora_acquire(req)
            except KVCacheExhausted:
                break
            if self.prefix_caching:
                try:
                    # salted with the adapter: a tenant's blocks hold its
                    # adapter's K/V and splice into no other tenant
                    reused, n_cached = cache.allocate_with_prefix(
                        req.req_id, toks, total,
                        salt=req.sampling.adapter_id)
                except RuntimeError:
                    self._lora_release(req)
                    break
                req.deps = [self._pending_writes[b] for b in reused
                            if b in self._pending_writes]
                table = cache.seq_blocks(req.req_id)
                bs = cache.block_size
                for j in range(len(reused), int(len(toks)) // bs):
                    self._pending_writes[table[j]] = \
                        (req, (j + 1) * bs - n_cached)
                    req.pending_blocks.append(table[j])
            else:
                if cache.free_blocks < -(-total // cache.block_size):
                    self._lora_release(req)
                    break
                try:
                    cache.allocate(req.req_id, total)
                except RuntimeError:
                    self._lora_release(req)
                    break
                n_cached = 0
            self._queue.popleft()
            req.ctx = toks if req.resume else None
            req.n_cached = n_cached
            req.state = "prefilling"
            req.slot = si
            now = time.perf_counter()
            if req.t_admit is None:
                req.t_admit = now
            if self.tracer is not None and req.trace_id is not None:
                self.tracer.span(
                    "queued", req.trace_id, req.t_queued or now, now,
                    pid=self.replica_id, epoch=req.epoch,
                    resume=bool(req.resume))
                self.tracer.event(
                    "admitted", trace=req.trace_id,
                    pid=self.replica_id, slot=si,
                    n_cached=int(n_cached), resume=bool(req.resume))
                req.t_life = now
            if req.resume:
                self.recompute_tokens += req.suffix_len
            self._slots[si] = req

    def _deps_ready(self, req: Request) -> bool:
        """True when every writer whose blocks ``req`` spliced has
        dispatched the rows covering them; met dependencies are
        dropped."""
        if req.deps:
            req.deps = [(w, need) for w, need in req.deps
                        if w.prefill_sent < need]
        if not req.deps:
            if req.t_wait is not None:
                # the splice wait is over: the reader held its rows back
                # this long for its writer's dispatches
                if self.tracer is not None and req.trace_id is not None:
                    self.tracer.span(
                        "splice_wait", req.trace_id, req.t_wait,
                        time.perf_counter(), pid=self.replica_id)
                req.t_wait = None
            return True
        if self.tracer is not None and req.t_wait is None:
            req.t_wait = time.perf_counter()
        return False

    def _clear_pending_writes(self, req: Request):
        for b in req.pending_blocks:
            if self._pending_writes.get(b, (None, 0))[0] is req:
                del self._pending_writes[b]
        req.pending_blocks = []

    def _is_finished(self, req: Request) -> bool:
        sp = req.sampling
        return (len(req.out_tokens) >= sp.max_new_tokens
                or (sp.eos_token_id is not None
                    and req.out_tokens[-1] == sp.eos_token_id))

    def _retire(self, si: int):
        req = self._slots[si]
        req.state = "done"
        req.t_done = time.perf_counter()
        # a finished request's ITL samples join the bounded reservoir
        # here; aborted and failed lives never reach _retire
        self._itl_res.extend(req.itls)
        if self.tracer is not None:
            if req.trace_id is not None:
                self._trace_life_end(req, "done", req.t_done)
                self.tracer.end_request(
                    req.trace_id, "done", replica=self.replica_id,
                    tokens=len(req.out_tokens))
            m = self.tracer.metrics
            if req.latency_s is not None:
                m.histogram("engine.latency_s").observe(req.latency_s)
            if req.ttft_s is not None:
                m.histogram("engine.ttft_s").observe(req.ttft_s)
        self._done[req.req_id] = req
        self._slots[si] = None
        self._lora_release(req)
        if self._inflight:
            # a chunk still in flight was dispatched assuming the request
            # continues and writes its pages: free them when the newest
            # one is collected, as JAX does
            self._inflight[-1]["free_after"].append(req.req_id)
        else:
            self.dec.cache.free(req.req_id)

    def _rep_active(self) -> bool:
        return any(r is not None and r.state == "running"
                   and r.sampling.repetition_penalty != 1.0
                   for r in self._slots)

    def _pick_chunk(self, active) -> int:
        """The ministep count T of this chunk. One rung: that rung.
        Several: queue pressure with EOS-able requests pins the smallest
        (such a slot may free any step). With the per-rung cost table
        that ``warmup`` measures, the rung that delivers the most tokens
        per second; without it the largest rung every running budget
        covers when nothing is queued, or the largest the
        soonest-draining slot covers when requests wait."""
        if self._force_chunk:
            return self._force_chunk
        if len(self.chunks) == 1:
            return self.chunks[0]
        if self._queue and any(
                self._slots[si].sampling.eos_token_id is not None
                for si in active):
            return self.chunks[0]
        lefts = [self._slots[si].sampling.max_new_tokens
                 - self._slots[si].planned for si in active]
        if self._chunk_cost:
            best, best_rate = self.chunks[0], -1.0
            for c in self.chunks:
                cost = self._chunk_cost.get(c)
                if cost is None:
                    continue
                rate = sum(min(c, max(0, lf)) for lf in lefts) / cost
                if rate > best_rate + 1e-9:
                    best, best_rate = c, rate
            return best
        bound = min(lefts) if self._queue else max(lefts)
        best = self.chunks[0]
        for c in self.chunks[1:]:
            if c <= bound:
                best = c
        return best

    def _ragged_width(self, w: int) -> int:
        for b in self.RAGGED_WIDTHS:
            if w <= b:
                return b
        return -(-w // 64) * 64

    def _newest_ragged_entry(self):
        for e in reversed(self._inflight):
            if e["kind"] == "ragged":
                return e
        return None

    def _ragged_plan(self):
        """(T, dcols, takes, fused): this step's decode columns (slot,
        request, ministeps) and prefill takes (request, tokens), computed
        without touching the allocator. ``fused``: a multi-step window,
        k times the rung, only while decodes run and no slot
        prefills."""
        running = [si for si in range(self.max_b)
                   if self._slots[si] is not None
                   and self._slots[si].state == "running"]
        T = self._force_chunk or (self._pick_chunk(running) if running
                                  else 1)
        fused = (self.multi_step > 1 and bool(running)
                 and not any(r is not None and r.state == "prefilling"
                             for r in self._slots))
        if fused:
            T *= self.multi_step
        dcols = []
        for si in running:
            req = self._slots[si]
            steps = max(0, min(T, req.sampling.max_new_tokens
                               - req.planned))
            if steps > 0:
                dcols.append((si, req, steps))
        # while decodes run, the budget bounds the prefill rows slotted
        # between consecutive ministep groups (the running streams'
        # added inter-token latency); an idle engine drains wider
        budget = self._ragged_cap if dcols \
            else max(self._ragged_cap, self._ragged_idle_cap)
        return T, dcols, self._prefill_takes(budget), fused

    def _prefill_takes(self, budget: int) -> List[Tuple[Request, int]]:
        """(request, tokens) prefill takes within ``budget`` rows, oldest
        request first."""
        takes = []
        pending = sorted((r for r in self._slots
                          if r is not None and r.state == "prefilling"
                          and r.prefill_sent < r.suffix_len),
                         key=lambda r: r.req_id)
        for r in pending:
            if budget <= 0:
                break
            if not self._deps_ready(r):
                # a splice reader never rides the same or an earlier
                # chunk than its writer's covering rows
                continue
            take = min(budget, r.suffix_len - r.prefill_sent)
            takes.append((r, take))
            budget -= take
        return takes

    def _place_prefill(self, rows: _ChunkRows, takes, pcells):
        """Lay the prefill takes over the free cells ``pcells`` in order,
        at most one sampling final per column (its seen row is seeded
        per column); a request whose extend finds no victim fails."""
        pi = 0
        for req, take in takes:
            if req.state != "prefilling" or req.slot is None:
                continue   # evicted by decode-side pressure mid-build
            si = req.slot
            src = req.prefill_tokens
            base = req.n_cached + req.prefill_sent
            cells = rows.rows_of.setdefault(req.req_id, [])
            rows.sched[req.req_id] = (req, req.epoch)
            scheduled = 0
            try:
                for j in range(take):
                    if pi >= len(pcells):
                        break
                    off = base + j
                    t, c = pcells[pi]
                    is_final = not req.resume and off + 1 == len(src)
                    if is_final:
                        while any(fc == c for *_, fc in rows.finals):
                            pi += 1
                            if pi >= len(pcells):
                                break
                            t, c = pcells[pi]
                        if pi >= len(pcells):
                            break
                    rows.slots[t, c] = self._extend_with_preempt(req)
                    rows.ids[t, c] = int(src[off])
                    rows.pos[t, c] = off
                    rows.rctx[t, c] = off + 1
                    rows.rseq[t, c] = si
                    cells.append((t, c))
                    scheduled += 1
                    pi += 1
                    if is_final:
                        rows.set_sampling(t, c, req.sampling, self.top_k)
                        rows.finals.append((req, req.epoch, t, c))
            except KVCacheExhausted as e:
                self._fail_request(
                    req, f"KV pool exhausted mid-prefill with no "
                         f"preemption victim: {e}")
                continue
            if scheduled:
                rows.take_of[req.req_id] = scheduled

    def _chunk_tables(self, sched) -> np.ndarray:
        """One block-table row per slot plus the scratch row at max_b;
        after the extends every block list is final for the dispatch."""
        tables = np.full((self.max_b + 1, self.dec.max_pages),
                         self._scratch_block, np.int32)
        for req, _ in sched.values():
            tables[req.slot] = self.dec.cache.block_table(
                req.req_id, self.dec.max_pages)
        return tables

    def _fail_dispatch(self, sched, what: str, e: Exception):
        """One program: every request riding it fails together."""
        for req, epoch in sched.values():
            if req.epoch == epoch and req.state in ("running", "prefilling"):
                self._fail_request(
                    req, f"{what} dispatch failed after retries: {e}")

    def _advance_prefill(self, sched, take_of):
        """The scheduled prefill rows are dispatched: move the splice
        watermark, complete resumes (decode goes on from the host's
        last token), drop the pending writes of finished finals."""
        for rid, (req, epoch) in sched.items():
            take = take_of.get(rid, 0)
            if take and req.state == "prefilling":
                req.prefill_sent += take
                if req.prefill_sent >= req.suffix_len:
                    if req.resume:
                        self._resume_complete(req)
                    else:
                        self._clear_pending_writes(req)

    def _dispatch_ragged(self) -> bool:
        """Dispatch this step's speculative verify chunk when a drafter
        proposes, else its unified chunk; with no running decode (cold
        start, burst admission) keep dispatching prefill-only chunks until
        no prompt token is left to send."""
        if self._dispatch_spec_chunk():
            return True
        if not self._dispatch_ragged_chunk():
            return False
        while (not any(r is not None and r.state == "running"
                       for r in self._slots)
               and self._dispatch_ragged_chunk()):
            pass
        return True

    # -- speculative decoding ------------------------------------------------
    def _dispatch_spec_chunk(self) -> bool:
        """Build and run ONE speculative verify ministep (JAX's
        ``_dispatch_spec_chunk``): every running column rides as its
        carried token plus, for a greedy column, the drafter's proposals
        at the next positions; prefill rows take what the drafts leave
        of the row budget. Returns False (the caller runs the plain
        chunk) without a drafter, while any slotted request is rich
        (its per-column seen mask does not compose with multi-row
        columns), with no running column, or when no column drafted.
        Collected in the same step: acceptance decides the next
        positions. Nothing is in flight here (the ragged engine
        collects within each step), so the history the drafter sees is
        exact and JAX's probe-before-flush has no case to serve."""
        if self.spec is None:
            return False
        if any(r is not None and r.sampling.needs_rich_sampling
               for r in self._slots):
            return False
        if not any(r is not None and r.state == "running"
                   for r in self._slots):
            return False
        t0 = time.perf_counter()
        cache = self.dec.cache
        dcols: List[Tuple[int, Request, np.ndarray]] = []
        total_drafts = 0
        for si in range(self.max_b):
            req = self._slots[si]
            if req is None or req.state != "running":
                continue
            left = req.sampling.max_new_tokens - req.planned
            if left <= 0:
                continue
            drafts = np.zeros(0, np.int32)
            if req.sampling.temperature <= 0.0 and left > 1:
                # clamped to the window and the budget, also after
                # propose: a draft past either could never be delivered
                k = min(self.spec.draft_len, left - 1)
                hist = np.concatenate(
                    [req.prompt, np.asarray(req.out_tokens, np.int32)])
                drafts = np.asarray(self._drafter.propose(hist, k),
                                    np.int32).reshape(-1)[:k]
            dcols.append((si, req, drafts))
            total_drafts += len(drafts)
        if total_drafts == 0:
            self.time_host_s += time.perf_counter() - t0
            return False
        # draft rows and prefill rows share the step's row budget
        takes = self._prefill_takes(max(0, self._ragged_cap - total_drafts))
        W = self._ragged_width(sum(1 + len(d) for _, _, d in dcols)
                               + sum(t for _, t in takes))
        r = _ChunkRows(1, W, self._scratch_slot, self.max_b,
                       use_ov=np.zeros((1, W), np.int32),
                       override=np.zeros((1, W), np.int32),
                       seg_start=np.arange(W, dtype=np.int32)[None],
                       is_draft=np.zeros((1, W), np.int32))
        spec_of: Dict[int, dict] = {}             # slot -> verify window
        col = 0
        for si, req, drafts in dcols:
            if self._slots[si] is not req or req.state != "running":
                continue   # preempted by an earlier column's pressure
            base, span = col, 1 + len(drafts)
            col += span    # the rows stay reserved even if preempted
            cells = r.rows_of.setdefault(req.req_id, [])
            r.sched[req.req_id] = (req, req.epoch)
            ctx0 = cache.context_len(req.req_id)
            # the table before the window's extends: a rollback drops
            # only blocks the window appended
            tbl0 = len(cache.seq_blocks(req.req_id))
            done = 0
            try:
                for j in range(span):
                    c = base + j
                    r.slots[0, c] = self._extend_with_preempt(req)
                    r.pos[0, c] = ctx0 + j
                    # the context and earlier drafts
                    r.rctx[0, c] = ctx0 + j + 1
                    r.rseq[0, c] = si
                    cells.append((0, c))
                    if j == 0:
                        r.use_ov[0, c] = 1
                        r.override[0, c] = self._last_tok[si]
                    else:
                        r.ids[0, c] = int(drafts[j - 1])
                        r.is_draft[0, c] = 1
                        r.seg_start[0, c] = base
                    done += 1
            except KVCacheExhausted:
                # the base row scheduled: truncate the window to what the
                # pool granted (preempting here would replay the same
                # window on resume); a base row that cannot extend
                # preempts or fails, as in the ragged chunk
                if done == 0:
                    if self._can_recompute:
                        self._preempt(req)
                    else:
                        self._fail_request(
                            req, "KV pool exhausted and decoder does not "
                                 "support preemption-with-recompute")
                    continue
            # a stochastic column rides as a one-row window and samples
            r.temps[0, base:base + done] = req.sampling.temperature
            spec_of[si] = {"req": req, "epoch": req.epoch, "base": base,
                           "k": done - 1, "ctx0": ctx0, "tbl0": tbl0}
        self._place_prefill(r, takes, [(0, c) for c in range(col, W)])
        for req in r.sweep():
            for vsi in [s for s, ent in spec_of.items()
                        if ent["req"] is req]:
                del spec_of[vsi]
        if not r.sched:
            self.time_host_s += time.perf_counter() - t0
            return False

        tables = self._chunk_tables(r.sched)
        self._fresh_slots.clear()
        arrays = [np.concatenate([r.ids, r.pos, r.slots, r.rseq, r.rctx,
                                  r.use_ov, r.seg_start, r.is_draft]),
                  r.override[0], tables, r.temps[0],
                  self._key_operand(self._next_key())]
        use_lora = self._use_lora(r.sched, r.rows_of)
        if use_lora:
            arrays.append(self._lora_tables_operand(r.sched))
        try:
            out, = self._device_call(
                "dispatch:spec", self.programs.run,
                "spec_lora" if use_lora else "spec",
                (W, bool((r.temps > 0.0).any())), arrays)
        except _DispatchFailed as e:
            self._fail_dispatch(r.sched, "spec", e)
            self.time_host_s += time.perf_counter() - t0
            return False
        host, ev = self._to_host(out)
        self._advance_prefill(r.sched, r.take_of)
        if self.tracer is not None:
            self.tracer.event(
                "dispatch", pid=self.replica_id, kind="spec",
                W=int(W), drafts=int(total_drafts),
                decode_cols=len(spec_of),
                prefill_rows=int(sum(r.take_of.values())))
        self._inflight.append({
            "kind": "spec", "host": host, "event": ev, "W": W,
            "spec": spec_of, "finals": r.finals,
            "real_rows": sum(r.take_of.values()), "free_after": []})
        self.time_host_s += time.perf_counter() - t0
        return True

    def _collect_spec(self, ch):
        """Deliver one verify ministep: per window the accepted drafts
        (off the program's mask) and the token after them, cut at EOS or
        the budget; the allocator rolls back to what was delivered, so
        the next extends reissue the rejected slots. Finals deliver
        first tokens as in the ragged chunk."""
        t0 = time.perf_counter()
        cache = self.dec.cache
        try:
            out = self._device_call("collect:spec", self._host_tokens, ch)
        except _DispatchFailed as e:
            self.time_stall_s += time.perf_counter() - t0
            for si, ent in ch["spec"].items():
                req = ent["req"]
                if req.state == "running" and req.epoch == ent["epoch"] \
                        and self._slots[si] is req:
                    self._fail_request(
                        req, f"spec collection failed after retries: {e}")
            self._fail_prefill_group(
                [(None, req, epoch) for req, epoch, _, _ in ch["finals"]],
                e)
            self._free_after(ch)
            return
        toks, acc = out[0], out[1]
        self.time_stall_s += time.perf_counter() - t0
        now = time.perf_counter()
        self.decode_steps += 1
        self.decode_slot_steps += ch["W"]
        self.decode_useful_tokens += ch["real_rows"]
        for si, ent in ch["spec"].items():
            req = ent["req"]
            if req.state != "running" or req.epoch != ent["epoch"] \
                    or self._slots[si] is not req:
                continue
            base, k, ctx0 = ent["base"], ent["k"], ent["ctx0"]
            m = 0
            while m < k and acc[base + 1 + m]:
                m += 1
            self.drafted_tokens += k
            self.accepted_draft_tokens += m
            if k:
                self.draft_acceptance_ema += 0.1 * (
                    m / k - self.draft_acceptance_ema)
            if m < k:
                self.spec_rollbacks += 1
            if self.tracer is not None and k:
                self.tracer.event(
                    "spec_window", trace=req.trace_id,
                    pid=self.replica_id, drafted=int(k), accepted=int(m))
            delivered = 0
            for j in range(m + 1):
                tok = int(toks[base + j])
                req.out_tokens.append(tok)
                delivered += 1
                self.generated_tokens += 1
                self._last_tok[si] = tok
                if self._is_finished(req):
                    break      # EOS inside the window
            self.decode_useful_tokens += delivered
            req.planned = len(req.out_tokens)
            self._note_itl(req, now, delivered)
            if k:
                self._drafter.observe(
                    np.concatenate([req.prompt,
                                    np.asarray(req.out_tokens, np.int32)]),
                    m, k)
            if self._is_finished(req) and self._slots[si] is req:
                self._retire(si)
            else:
                # the context ends at the delivered prefix's K/V (the
                # last token's K/V is the next step's write)
                cache.rollback(req.req_id, ctx0 + delivered,
                               min_blocks=ent["tbl0"])
        for req, epoch, _, c in ch["finals"]:
            self._first_token(req, epoch, int(toks[c]), now)
        self._free_after(ch)

    def _dispatch_ragged_chunk(self) -> bool:
        """Build and run ONE unified chunk: decode columns first (their
        tokens carried ministep to ministep on the device), then this
        step's prefill tokens ministep-major over the remaining columns
        (a row lands at the same or a later ministep than every earlier
        row of its request, and pool writes precede attention inside a
        ministep, so row_ctx alone keeps the chunk causal). A request
        preempted while the chunk is built has every cell it was given
        re-aimed at the scratch page (``blank``): a later row of this
        chunk may take its freed blocks. Returns True when a chunk
        ran."""
        t0 = time.perf_counter()
        cache = self.dec.cache
        T, dcols, takes, fused = self._ragged_plan()
        if not dcols and not takes:
            self.time_host_s += time.perf_counter() - t0
            return False

        def width(dcols, takes):
            ptotal = sum(t for _, t in takes)
            return self._ragged_width(len(dcols)
                                      + (-(-ptotal // T) if ptotal else 0))

        W = width(dcols, takes)
        prev = self._newest_ragged_entry()
        if prev is not None and prev["T"] == T and W < prev["W"]:
            W = prev["W"]      # sticky width: a shrink keeps the width
        if prev is not None and (prev["T"] != T or prev["W"] != W):
            # another shape than the chunk in flight: collect first, as
            # JAX does, and plan again on what collection changed
            while self._inflight:
                self._collect_oldest()
            T, dcols, takes, fused = self._ragged_plan()
            if not dcols and not takes:
                self.time_host_s += time.perf_counter() - t0
                return False
            W = width(dcols, takes)

        r = _ChunkRows(T, W, self._scratch_slot, self.max_b,
                       ucar=np.zeros((T, W), np.int32),
                       top_ks=np.zeros((T, W), np.int32),
                       top_ps=np.ones((T, W), np.float32),
                       reps=np.ones((T, W), np.float32))
        upd = np.zeros(W, np.int32)
        override = np.zeros(W, np.int32)
        col_of: Dict[int, int] = {}
        steps_of: Dict[int, int] = {}
        reqs_of: Dict[int, Request] = {}
        epochs_of: Dict[int, int] = {}
        col = 0
        for si, req, steps in dcols:
            if self._slots[si] is not req or req.state != "running":
                continue        # preempted by an earlier column
            cells = r.rows_of.setdefault(req.req_id, [])
            # registered before the extends: if req becomes its own
            # victim, the sweep below blanks its partial rows
            r.sched[req.req_id] = (req, req.epoch)
            try:
                for t in range(steps):
                    ctx = cache.context_len(req.req_id)
                    r.slots[t, col] = self._extend_with_preempt(req)
                    r.pos[t, col] = ctx
                    r.rctx[t, col] = ctx + 1
                    r.rseq[t, col] = si
                    cells.append((t, col))
            except KVCacheExhausted:
                if self._can_recompute:
                    self._preempt(req)
                else:
                    self._fail_request(
                        req, "KV pool exhausted and decoder does not "
                             "support preemption-with-recompute")
                col += 1
                continue
            req.planned += steps
            r.ucar[:, col] = 1
            for t in range(T):
                r.set_sampling(t, col, req.sampling, self.top_k)
            upd[col] = 1
            override[col] = self._last_tok[si]
            col_of[si] = col
            steps_of[si] = steps
            reqs_of[si] = req
            epochs_of[si] = req.epoch
            col += 1

        self._place_prefill(r, takes, [(t, c) for t in range(T)
                                       for c in range(col, W)])
        for req in r.sweep():
            for si in [s for s, q in reqs_of.items() if q is req]:
                c = col_of.pop(si, None)
                if c is not None:
                    upd[c] = 0
                    r.ucar[:, c] = 0
                steps_of.pop(si, None)
                reqs_of.pop(si, None)
                epochs_of.pop(si, None)
        if not r.sched:
            self.time_host_s += time.perf_counter() - t0
            return False

        finals = r.finals
        rich = any(q.sampling.needs_rich_sampling
                   for q in reqs_of.values()) \
            or any(f[0].sampling.needs_rich_sampling for f in finals)
        sampled = bool((r.temps > 0.0).any())
        keys = self._key_operand(prng.split(self._next_key(), T))
        arrays = [override, np.stack([r.ids, r.pos, r.slots, r.rseq, r.rctx,
                                      r.ucar]),
                  self._chunk_tables(r.sched), r.temps, keys]
        if fused:
            # each surviving decode column's EOS id (-1: none), after the
            # staleness sweep, so a blanked column keeps -1
            eos = np.full(W, -1, np.int32)
            for si, c in col_of.items():
                e = reqs_of[si].sampling.eos_token_id
                if e is not None:
                    eos[c] = e
            arrays.append(eos)
            self.ms_windows += 1
        use_lora = self._use_lora(r.sched, r.rows_of)
        if use_lora:
            arrays.append(self._lora_tables_operand(r.sched))
        if rich:
            arrays += [r.top_ks, r.top_ps, r.reps, upd]
            self._write_masks(
                {c: reqs_of[si] for si, c in col_of.items()},
                {c: req for req, _, _, c in finals})
            self.masked_decode_columns += sum(
                1 for q in reqs_of.values() if q.allowed_mask is not None)
        try:
            toks, = self._device_call(
                "dispatch:ragged", self.programs.run,
                self._ragged_family(fused, use_lora),
                (T, W, sampled, rich), arrays)
        except _DispatchFailed as e:
            self._fail_dispatch(r.sched, "ragged", e)
            self.time_host_s += time.perf_counter() - t0
            return False
        host, ev = self._to_host(toks)
        self._advance_prefill(r.sched, r.take_of)
        if self.tracer is not None:
            self.tracer.event(
                "dispatch", pid=self.replica_id, kind="ragged",
                T=int(T), W=int(W), decode_cols=len(col_of),
                prefill_rows=int(sum(r.take_of.values())),
                finals=len(finals),
                k=int(self.multi_step if fused else 1),
                decode_toks=int(sum(steps_of.values())))
        self._inflight.append({
            "kind": "ragged", "free_after": [], "host": host, "event": ev,
            "T": T, "W": W, "cols": col_of, "steps": steps_of,
            "reqs": reqs_of, "epochs": epochs_of, "finals": finals,
            "real_rows": sum(r.take_of.values()), "fused": fused})
        self.time_host_s += time.perf_counter() - t0
        return True

    def _write_masks(self, decode_rows: Dict[int, Request],
                     final_rows: Dict[int, Request]):
        """Bring the mask planes to what one rich dispatch reads: the
        allowed row of every consuming row (its request's mask, or all
        ones), and the seen row of every repetition-penalty row (the
        prompt, plus the generated tokens for a decode row). Rows whose
        output is never consumed, and seen rows without a penalty, are
        left as they are: the sampler does not read them."""
        planes = self._mask_planes()
        allowed, seen = {}, {}
        for rows, decode in ((decode_rows, True), (final_rows, False)):
            for r, req in rows.items():
                allowed[r] = (req.allowed_serial, req.allowed_mask
                              if req.allowed_mask is not None
                              else np.ones(planes.vocab, bool))
                if req.sampling.repetition_penalty == 1.0:
                    continue
                toks = list(req.out_tokens) if decode else []

                def make(req=req, toks=toks):
                    row = np.zeros(planes.vocab, bool)
                    row[req.prompt] = True
                    if toks:
                        row[np.asarray(toks)] = True
                    return row
                seen[r] = ((req.req_id, len(toks)), make)
        planes.write("allowed", allowed)
        planes.write("seen", seen)

    # -- the program families (inference/programs.py) ------------------------
    @staticmethod
    def _ragged_family(fused: bool, use_lora: bool) -> str:
        """The family of a ragged chunk: ragged, ragged_ms, ragged_lora or
        ragged_ms_lora; rich is in the key."""
        return ("ragged" + ("_ms" if fused else "")
                + ("_lora" if use_lora else ""))

    def _ragged_program(self, key, override, sched, tables, temps, keys,
                        *rest, ms: bool = False, lora: bool = False):
        """The ragged chunk, key (T, W, sampled, rich): T ministeps. sched
        [6, T, W] int32 holds ids, positions, slots, row_seq, row_ctx and
        the carry flag; a carry column takes the token sampled in the
        previous ministep (its first from ``override`` [W]); tables
        [max_b + 1, max_pages]; temps [T, W]; keys [T, 2] (ministep t
        draws with keys[t]). Then, by family: a multi-step window (``ms``)
        takes eos [W] (-1: none) and keeps a per-column live mask: once
        a column samples its EOS, later ministeps write its K/V to the
        scratch slot and repeat its token; a lora twin takes the adapter
        page tables [max_b + 1, n_pages], gathered once for the whole
        chunk. A rich chunk then takes top_ks / top_ps / reps [T, W] and
        upd [W]: the seen mask is a copy of the seen plane's first W
        rows, and only upd columns (decode columns, while live) add
        their samples to it. Returns (tokens [T, W],)."""
        _, W, sampled, rich = key
        dec = self.dec
        cache = dec.cache
        rest = list(rest)
        eos = rest.pop(0) if ms else None
        lctx = dec.lora_context(self.lora.layout, cache.lora_pool,
                                rest.pop(0)) if lora else None
        if rich:
            top_ks, top_ps, reps, upd = rest
            planes = self._mask_planes()
            seen = planes.seen[:W].clone()
            allowed = planes.allowed[:W]
            rows = torch.arange(W, device=override.device)
            updb = upd != 0
        if ms:
            live = torch.ones(W, dtype=torch.bool, device=override.device)
        cur = override
        out = []
        for t in range(sched.shape[1]):
            ids = torch.where(sched[5, t] != 0, cur, sched[0, t])
            slots = sched[2, t]
            if ms:
                slots = slots.masked_fill(~live, self._scratch_slot)
            logits, _, _ = dec._ragged_logits(
                dec.weights, cache.k, cache.v, ids, sched[1, t], slots,
                sched[3, t], sched[4, t], tables, lora=lctx)
            if rich:
                nxt = self._sample_rich(logits, temps[t], keys[t],
                                        top_ks[t], top_ps[t], reps[t],
                                        seen, allowed, sampled)
            else:
                nxt = self._sample(logits, temps[t], keys[t], sampled)
            if ms:
                nxt = torch.where(live, nxt, cur)
            if rich:
                hit = nxt.long()
                seen[rows, hit] = seen[rows, hit] | (updb & live if ms
                                                     else updb)
            if ms:
                live = live & (nxt != eos)
            cur = nxt
            out.append(cur)
        return (torch.stack(out),)

    def _spec_program(self, key, sched, override, tables, temps, rkey,
                      *lora_tables, lora: bool = False):
        """One speculative verify ministep, key (W, sampled): sched [8, W]
        int32 holds ids (a draft row's proposal), positions, slots,
        row_seq, row_ctx, use_ov (a column base row, whose token is
        ``override``), seg_start and is_draft; tables [max_b + 1,
        max_pages]; temps [W]; rkey [2], the dispatch's whole key; a
        lora twin also the adapter page tables. ``_spec_accept`` runs
        after the forward. Returns ([2, W]: the sampled tokens and the
        accepted mask,)."""
        dec = self.dec
        cache = dec.cache
        ids, pos, slots, rseq, rctx, use_ov, seg, is_draft = sched
        lctx = dec.lora_context(self.lora.layout, cache.lora_pool,
                                lora_tables[0]) if lora else None
        logits, _, _ = dec._ragged_logits(
            dec.weights, cache.k, cache.v,
            torch.where(use_ov != 0, override, ids), pos, slots, rseq,
            rctx, tables, lora=lctx)
        toks = self._sample(logits, temps, rkey, key[1])
        acc, _, _ = dec._spec_accept(cache.k, cache.v, toks, ids, slots,
                                     seg, is_draft, self._scratch_slot)
        return (torch.stack([toks, acc.to(torch.int32)]),)

    def _decode_program(self, key, tables, ctx, slots, last_idx, over,
                        use_host, temps, keys, *rich_ops):
        """The dense decode chunk, key (T, sampled, rich): first tokens
        merged from the previous chunk's tokens in ``_carry`` (at each
        slot's ``last_idx``) or the host's ``over`` where ``use_host``,
        then T steps over tables [T, mb, max_pages], ctx / slots [T, mb],
        temps [mb], keys [T, 2]. A rich chunk also takes top_ks / top_ps
        / reps [mb] and carries a copy of the seen plane's first mb rows,
        every step's samples added. The tokens [mb, T] are also written
        to ``_carry``. Returns (tokens,)."""
        T, sampled, rich = key
        mb = self.max_b
        rows = torch.arange(mb, device=over.device)
        first = torch.where(use_host != 0, over,
                            self._carry[rows, last_idx.long()])
        if rich:
            top_ks, top_ps, reps = rich_ops
            planes = self._mask_planes()
            seen = planes.seen[:mb].clone()
            allowed = planes.allowed[:mb]
            # a device tensor, not a Python True: a scalar operand would
            # be a host-to-device copy, which a graph cannot capture
            hit = torch.ones(mb, dtype=torch.bool, device=over.device)
        step = [0]

        def sample(logits):
            t = step[0]
            step[0] += 1
            if not rich:
                return self._sample(logits, temps, keys[t], sampled)
            nxt = self._sample_rich(logits, temps, keys[t], top_ks, top_ps,
                                    reps, seen, allowed, sampled)
            seen[rows, nxt.long()] = hit
            return nxt

        dec = self.dec
        toks, _, _ = dec._decode_scan_impl(
            dec.weights, dec.cache.k, dec.cache.v, first, tables, ctx, slots,
            sample=sample)
        self._carry[:, :T].copy_(toks)
        return (toks,)

    def _final_program(self, key, ids, slots, last_idx, *rest):
        """A dense final prefill, key (bucket, rows, sampled, rich): ids /
        slots [rows, bucket], last_idx [rows]; the prefix family takes
        n_cached [rows] and prefix tables [rows, prefix_pages]; then
        temps [rows] and the key [2]; a rich final also top_ks / top_ps /
        reps [rows] over the mask planes' first rows. Returns (first
        tokens [rows],)."""
        _, gp, sampled, rich = key
        dec = self.dec
        cache = dec.cache
        if rich:
            rest, (top_ks, top_ps, reps) = rest[:-3], rest[-3:]
        if len(rest) == 4:
            ncv, ptab, temps, keys = rest
            logits, _, _ = dec._prefill_prefix_impl(
                dec.weights, cache.k, cache.v, ids, slots, last_idx, ncv,
                ptab)
        else:
            temps, keys = rest
            logits, _, _ = dec._prefill_impl(dec.weights, cache.k, cache.v,
                                             ids, slots, last_idx)
        if not rich:
            return (self._sample(logits, temps, keys, sampled),)
        planes = self._mask_planes()
        return (self._sample_rich(logits, temps, keys, top_ks, top_ps, reps,
                                  planes.seen[:gp], planes.allowed[:gp],
                                  sampled),)

    def _mid_program(self, key, ids, slots, *prefix):
        """A no-sample mid chunk, ids / slots [1, width]: at offset 0
        (key (width,)) through ``_prefill_impl``, or with the offset [1]
        and the prefix table [1, pages] (key (width, pages)) through
        ``_prefill_prefix_impl``. Writes K/V only; a resume's short
        tail pads its ids with zeros aimed at the scratch slot."""
        dec = self.dec
        cache = dec.cache
        if prefix:
            off, ptab = prefix
            dec._prefill_prefix_impl(dec.weights, cache.k, cache.v, ids,
                                     slots, None, off, ptab, logits=False)
        else:
            dec._prefill_impl(dec.weights, cache.k, cache.v, ids, slots,
                              logits=False)
        return ()

    def _sample(self, logits, temp, key, sampled: bool):
        """JAX's ``_sample``: per-row temperature (<= 0: greedy argmax)
        and the engine's top_k, drawn by ``categorical(key, logits /
        t)``. ``sampled``, static for a program, says some row has
        temperature > 0; without one nothing is drawn."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not sampled:
            return greedy
        if self.top_k > 0:
            kth = logits.topk(self.top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, -1e30), logits)
        t = temp.clamp(min=1e-6)[:, None]
        drawn = prng.categorical(key, logits / t)
        return torch.where(temp > 0.0, drawn, greedy)

    def _sample_rich(self, logits, temp, key, top_ks, top_ps, rep, seen,
                     allowed, sampled: bool):
        """JAX's ``_sample_rich``: the repetition penalty over ``seen``
        (positive logits divided, negative ones multiplied), the allowed
        mask before the greedy argmax, then one descending sort serving
        the per-row top_k (the k-th largest tempered logit) and top_p
        (the nucleus of the top_k-filtered distribution), and
        ``categorical``. logits [rows, V] float32; temp / top_ps / rep
        [rows] float32; top_ks [rows] int32; seen / allowed [rows, V]
        bool. Without ``sampled`` the filters and the draw are skipped:
        every row is greedy."""
        v = logits.shape[-1]
        neg = torch.full_like(logits, -1e30)
        repc = rep[:, None]
        pen = torch.where(logits > 0, logits / repc, logits * repc)
        logits = torch.where(seen & (rep != 1.0)[:, None], pen, logits)
        logits = torch.where(allowed, logits, neg)
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not sampled:
            return greedy
        lt = logits / temp.clamp(min=1e-6)[:, None]
        sorted_l = torch.sort(lt, dim=-1, descending=True).values
        k_idx = (top_ks.long() - 1).clamp(0, v - 1)
        kth = sorted_l.gather(1, k_idx[:, None])
        has_k = (top_ks > 0)[:, None]
        lt = torch.where(has_k & (lt < kth), neg, lt)
        rank = torch.arange(v, device=logits.device)[None, :]
        sorted_k = torch.where(has_k & (rank >= top_ks[:, None].long()),
                               neg, sorted_l)
        probs = torch.softmax(sorted_k, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = cum - probs > top_ps[:, None]
        pth = torch.where(cutoff, torch.full_like(sorted_k, float("inf")),
                          sorted_k).min(dim=-1, keepdim=True).values
        lt = torch.where((top_ps < 1.0)[:, None] & (lt < pth), neg, lt)
        drawn = prng.categorical(key, lt)
        return torch.where(temp > 0.0, drawn, greedy)

    # -- the dense per-phase path ------------------------------------------
    def _to_host(self, toks):
        """Start the copy of a chunk's device tokens to the host: (host
        tensor, event to wait on, or None on the CPU)."""
        if self.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    @staticmethod
    def _host_tokens(ch) -> np.ndarray:
        """A chunk's tokens on the host: the one sync of collection."""
        if ch["event"] is not None:
            ch["event"].synchronize()
        return ch["host"].numpy()

    def _dispatch_prefill(self):
        """Dispatch prefill work for prefilling slots, oldest request
        first. While decodes run, the tokens dispatched this step are
        capped at ``prefill_budget``; an idle engine dispatches
        everything ready. A remainder longer than ``prefill_chunk``, and
        every chunk of a resume, goes out as a width-1 mid chunk; a
        remainder that fits one dispatch is a final, grouped with the
        other ready finals of its bucket (closing a group early when it
        crosses the budget)."""
        pending = sorted((r for r in self._slots
                          if r is not None and r.state == "prefilling"
                          and r.prefill_sent < r.suffix_len),
                         key=lambda r: r.req_id)
        if not pending:
            return
        decoding = any(r is not None and r.state == "running"
                       for r in self._slots)
        budget = self.prefill_budget if (decoding and
                                         self.prefill_budget) else None

        def is_mid(r):
            # a resume runs every chunk through the no-sample program:
            # its next token is known, and drawing would shift the key
            # stream of every other request
            if r.resume:
                return True
            return (self.prefill_chunk is not None
                    and r.suffix_len - r.prefill_sent > self.prefill_chunk)

        spent = 0
        while True:
            ready = [r for r in pending
                     if r.state == "prefilling" and r.slot is not None
                     and r.prefill_sent < r.suffix_len
                     and self._deps_ready(r)]
            if not ready:
                return
            # strict FIFO: the oldest request's next dispatch goes first
            head = ready[0]
            if is_mid(head):
                spent += self._dispatch_mid(head)
                if budget is not None and spent >= budget:
                    return
                continue
            bucket = _bucket_for(head.suffix_len - head.prefill_sent,
                                 self.buckets)
            group = [(r.slot, r, r.n_cached + r.prefill_sent)
                     for r in ready if not is_mid(r)
                     and _bucket_for(r.suffix_len - r.prefill_sent,
                                     self.buckets) == bucket]
            w = min(self.PREFILL_GROUP, self.max_b) \
                if len(group) > 1 else 1
            sub, toks = [], 0
            for row in group:
                if row[1].state != "prefilling" or row[1].slot is None:
                    # preempted by an earlier sub-group's pressure: it
                    # comes back through the queue
                    continue
                sub.append(row)
                toks += int(row[1].prompt.size) - row[2]
                if len(sub) == w or (budget is not None
                                     and spent + toks >= budget):
                    self._dispatch_final(bucket, sub, w)
                    spent += toks
                    sub, toks = [], 0
                    if budget is not None and spent >= budget:
                        return
            if sub:
                self._dispatch_final(bucket, sub, w)
                spent += toks
                if budget is not None and spent >= budget:
                    return

    def _dispatch_mid(self, req: Request) -> int:
        """Dispatch ONE no-sample prefill chunk (width 1) at offset
        n_cached + prefill_sent; the pages before it ride along as a
        scratch-padded prefix table whose width is the next power-of-two
        rung. A resume's last chunk may be short: its ids pad with
        zeros aimed at the scratch slot. Returns the tokens dispatched
        (0 when the request failed)."""
        t0 = time.perf_counter()
        cache = self.dec.cache
        c = self.prefill_chunk or self._recompute_chunk
        src = req.prefill_tokens
        off = req.n_cached + req.prefill_sent
        take = min(c, req.suffix_len - req.prefill_sent)
        ids = np.zeros((1, c), np.int32)
        ids[0, :take] = src[off:off + take]
        slots = np.full((1, c), self._scratch_slot, np.int32)
        try:
            for j in range(take):
                slots[0, j] = self._extend_with_preempt(req)
        except KVCacheExhausted as e:
            self.time_prefill_s += time.perf_counter() - t0
            self._fail_request(req, f"KV pool exhausted mid-prefill "
                                    f"with no preemption victim: {e}")
            return 0
        try:
            if off:
                need = -(-off // cache.block_size)
                width = next(b for b in self._prefix_page_buckets
                             if b >= need)
                ptab = np.full((1, width), self._scratch_block, np.int32)
                pb = cache.seq_blocks(req.req_id)[:need]
                ptab[0, :len(pb)] = pb
                self._device_call(
                    "dispatch:prefill_mid", self.programs.run,
                    "prefill_mid", (c, width),
                    [ids, slots, np.asarray([off], np.int32), ptab])
            else:
                self._device_call("dispatch:prefill_mid", self.programs.run,
                                  "prefill_mid0", (c,), [ids, slots])
        except _DispatchFailed as e:
            self.time_prefill_s += time.perf_counter() - t0
            self._fail_request(req, f"prefill dispatch failed after "
                                    f"retries: {e}")
            return 0
        req.prefill_sent += take
        if self.tracer is not None:
            self.tracer.event(
                "dispatch", trace=req.trace_id, pid=self.replica_id,
                kind="prefill_mid", rows=1, tokens=int(take),
                offset=int(off))
        self._inflight.append({"kind": "prefill", "toks": None,
                               "group": [], "free_after": []})
        if req.resume and req.prefill_sent >= req.suffix_len:
            self._resume_complete(req)
        self.time_prefill_s += time.perf_counter() - t0
        return take

    def _resume_complete(self, req: Request):
        """A resume finishes at dispatch: no sampling final; decode goes
        on from the last token already emitted, supplied from the host
        like a fresh prefill's first token."""
        req.state = "running"
        if self.tracer is not None:
            self._trace_running(req, time.perf_counter())
        self._clear_pending_writes(req)
        si = req.slot
        self._last_tok[si] = req.out_tokens[-1]
        self._fresh_slots.add(si)
        req.planned = len(req.out_tokens)

    def _dispatch_final(self, bucket: int, group, gp: int):
        """Dispatch one FINAL (first-token sampling) prefill of ``gp``
        rows for ``group`` rows (slot, request, offset) whose remaining
        prompt fits ``bucket``: ids right-padded, pad tokens aimed at
        the scratch slot, extra rows all padding. A group with an offset
        row takes the offset program with the covered pages as its
        prefix table; a cold-start group takes the flash prefill."""
        t0 = time.perf_counter()
        cache = self.dec.cache
        ids = np.zeros((gp, bucket), np.int32)
        slots = np.full((gp, bucket), self._scratch_slot, np.int32)
        last_idx = np.zeros(gp, np.int32)
        ncv = np.zeros(gp, np.int32)
        ptab = np.full((gp, self._prefix_pages), self._scratch_block,
                       np.int32)
        temps = np.zeros(gp, np.float32)
        top_ks = np.zeros(gp, np.int32)
        top_ps = np.ones(gp, np.float32)
        reps = np.ones(gp, np.float32)
        members = [req for _, req, _ in group]
        try:
            for row, (_si, req, off) in enumerate(group):
                n = int(req.prompt.size) - off
                ids[row, :n] = req.prompt[off:]
                slots[row, :n] = [
                    self._extend_with_preempt(req, exclude=members)
                    for _ in range(n)]
                last_idx[row] = n - 1
                ncv[row] = off
                if off:
                    pb = cache.seq_blocks(req.req_id)[
                        : -(-off // cache.block_size)]
                    ptab[row, :len(pb)] = pb
                sp = req.sampling
                temps[row] = sp.temperature
                top_ks[row] = self.top_k if sp.top_k is None else sp.top_k
                top_ps[row] = sp.top_p
                reps[row] = sp.repetition_penalty
        except KVCacheExhausted as e:
            # the group shares one dispatch: fail it whole
            self.time_prefill_s += time.perf_counter() - t0
            for req in members:
                self._fail_request(
                    req, f"KV pool exhausted building prefill group: {e}")
            return
        rich = any(r.sampling.needs_rich_sampling for r in members)
        key = (bucket, gp, bool((temps > 0.0).any()), rich)
        tail = [temps, self._key_operand(self._next_key())]
        if rich:
            tail += [top_ks, top_ps, reps]
            self._write_masks({}, dict(enumerate(members)))
        try:
            if any(off for _, _, off in group):
                toks, = self._device_call(
                    "dispatch:prefill", self.programs.run, "prefill_prefix",
                    key, [ids, slots, last_idx, ncv, ptab] + tail)
            else:
                toks, = self._device_call(
                    "dispatch:prefill", self.programs.run, "prefill", key,
                    [ids, slots, last_idx] + tail)
        except _DispatchFailed as e:
            self.time_prefill_s += time.perf_counter() - t0
            for req in members:
                self._fail_request(
                    req, f"prefill dispatch failed after retries: {e}")
            return
        host, ev = self._to_host(toks)
        for _si, req, _off in group:
            req.prefill_sent = req.suffix_len
            self._clear_pending_writes(req)
        if self.tracer is not None:
            self.tracer.event("dispatch", pid=self.replica_id,
                              kind="prefill", rows=int(gp),
                              bucket=int(bucket))
        self._inflight.append({"kind": "prefill", "toks": toks,
                               "host": host, "event": ev,
                               "group": [(si, req, req.epoch)
                                         for si, req, _ in group],
                               "free_after": []})
        self.time_prefill_s += time.perf_counter() - t0

    def _prefill_complete(self, toks: np.ndarray, group):
        """A collected final: each request still in the life it was
        dispatched in leaves "prefilling" with its first token."""
        now = time.perf_counter()
        for row, (si, req, epoch) in enumerate(group):
            if req.state != "prefilling" or req.epoch != epoch:
                continue
            tok = int(toks[row])
            req.state = "running"
            if self.tracer is not None:
                self._trace_running(req, now)
            self._mark_first_token(req, now)
            req.out_tokens.append(tok)
            req.planned = 1
            self.generated_tokens += 1
            self._last_tok[si] = tok
            self._fresh_slots.add(si)
            if self._is_finished(req):
                self._retire(si)

    def _newest_decode_entry(self):
        for e in reversed(self._inflight):
            if e["kind"] == "decode":
                return e
        return None

    def _dispatch_chunk(self) -> bool:
        """Dispatch ONE decode chunk of T steps over all max_batch_size
        slots without waiting for the previous one. Slots past their
        token budget, inactive or still prefilling aim at the scratch
        page with ctx 0. First tokens of continuing slots come from the
        newest in-flight decode chunk's device output, fresh slots'
        from the host. A slot preempted while the chunk is built is
        re-aimed at the scratch page (``neutralize``): a later slot may
        take its freed blocks. Returns True when a chunk was
        dispatched."""
        t0 = time.perf_counter()
        cache = self.dec.cache
        active = [si for si in range(self.max_b)
                  if self._slots[si] is not None
                  and self._slots[si].state == "running"]
        if not active:
            self.time_host_s += time.perf_counter() - t0
            return False
        T = self._pick_chunk(active)
        mb, mp = self.max_b, self.dec.max_pages
        tables = np.full((T, mb, mp), self._scratch_block, np.int32)
        ctx = np.zeros((T, mb), np.int32)
        slots = np.full((T, mb), self._scratch_slot, np.int32)
        temps = np.zeros(mb, np.float32)
        top_ks = np.zeros(mb, np.int32)
        top_ps = np.ones(mb, np.float32)
        reps = np.ones(mb, np.float32)
        steps_of: Dict[int, int] = {}
        reqs_of: Dict[int, Request] = {}
        epochs_of: Dict[int, int] = {}

        def neutralize(vsi: int):
            slots[:, vsi] = self._scratch_slot
            ctx[:, vsi] = 0
            tables[:, vsi, :] = self._scratch_block
            steps_of.pop(vsi, None)
            reqs_of.pop(vsi, None)
            epochs_of.pop(vsi, None)
            temps[vsi] = 0.0
            top_ks[vsi] = 0
            top_ps[vsi] = 1.0
            reps[vsi] = 1.0

        for si in active:
            req = self._slots[si]
            if req is None or req.state != "running":
                continue    # preempted by an earlier slot's pressure
            sp = req.sampling
            # the budget at DISPATCH time: tokens planned, not fetched
            steps = max(0, min(T, sp.max_new_tokens - req.planned))
            try:
                for t in range(steps):
                    ctx[t, si] = cache.context_len(req.req_id)
                    while True:
                        try:
                            slots[t, si] = cache.extend(req.req_id)
                            break
                        except KVCacheExhausted:
                            victim = self._pick_victim()
                            if victim is None or victim is req:
                                raise
                            vsi = victim.slot
                            self._preempt(victim)
                            if vsi is not None:
                                neutralize(vsi)
            except KVCacheExhausted:
                # req is the policy victim itself (or nothing can be
                # preempted): its partial rows are blanked, as its
                # pages may go to a later slot of this chunk
                if self._can_recompute:
                    self._preempt(req)
                else:
                    self._fail_request(
                        req, "KV pool exhausted and decoder does not "
                             "support preemption-with-recompute")
                neutralize(si)
                continue
            req.planned += steps
            steps_of[si] = steps
            reqs_of[si] = req
            epochs_of[si] = req.epoch
            temps[si] = sp.temperature
            top_ks[si] = self.top_k if sp.top_k is None else sp.top_k
            top_ps[si] = sp.top_p
            reps[si] = sp.repetition_penalty
            # after the extends the block list is final for the chunk
            tables[:, si, :] = cache.block_table(req.req_id, mp)[None]
        # over the survivors only: a neutralized row no longer counts
        rich = any(r.sampling.needs_rich_sampling for r in reqs_of.values())
        if all(s == 0 for s in steps_of.values()):
            # every running slot is drained and awaits collection
            self.time_host_s += time.perf_counter() - t0
            return False
        prev = self._newest_decode_entry()
        last_idx = np.zeros(mb, np.int32)
        use_host = np.ones(mb, np.int32)
        if prev is not None:
            for si, req in reqs_of.items():
                psteps = prev["steps"].get(si, 0)
                if (psteps > 0 and si not in self._fresh_slots
                        and prev["reqs"].get(si) is req
                        and prev["epochs"].get(si) == req.epoch):
                    use_host[si] = 0
                    last_idx[si] = psteps - 1
        self._fresh_slots.clear()
        keys = self._key_operand(prng.split(self._next_key(), T))
        arrays = [tables, ctx, slots, last_idx,
                  self._last_tok.astype(np.int32), use_host, temps, keys]
        if rich:
            arrays += [top_ks, top_ps, reps]
            self._write_masks(dict(reqs_of), {})
            self.masked_decode_columns += sum(
                1 for si, r in reqs_of.items()
                if r.allowed_mask is not None and steps_of.get(si, 0) > 0)
        try:
            toks, = self._device_call(
                "dispatch:decode", self.programs.run, "decode",
                (T, bool((temps > 0.0).any()), rich), arrays)
        except _DispatchFailed as e:
            # the chunk's requests fail; 0-step slots awaiting
            # collection and prefilling requests are untouched
            for si, steps in steps_of.items():
                req = reqs_of[si]
                if steps > 0 and self._slots[si] is req \
                        and req.state == "running":
                    self._fail_request(
                        req, f"decode dispatch failed after retries: {e}")
            self.time_host_s += time.perf_counter() - t0
            return False
        if prev is not None:
            # the merge, JAX's own program before the decode chunk (a
            # dispatch that failed ran neither)
            self.device_dispatches += 1
        host, ev = self._to_host(toks)
        if self.tracer is not None:
            self.tracer.event(
                "dispatch", pid=self.replica_id, kind="decode",
                T=int(T), width=self.max_b,
                rows=sum(1 for n in steps_of.values() if n > 0),
                tokens=int(sum(steps_of.values())))
        self._inflight.append({"kind": "decode",
                               "host": host, "event": ev,
                               "steps": steps_of, "reqs": reqs_of,
                               "epochs": epochs_of,
                               "T": T, "free_after": []})
        self.time_host_s += time.perf_counter() - t0
        return True

    def _free_after(self, ch):
        for rid in ch["free_after"]:
            self.dec.cache.free(rid)

    def _collect_oldest(self):
        """Collect the oldest in-flight chunk: a mid prefill carries no
        result, a final delivers first tokens, a decode chunk up to T
        tokens per slot (with the mid-chunk EOS cut), a ragged chunk
        through ``_collect_ragged``. A collection that outlives its
        retries fails the requests waiting on it."""
        ch = self._inflight.popleft()
        if ch["kind"] == "ragged":
            self._collect_ragged(ch)
            return
        if ch["kind"] == "spec":
            self._collect_spec(ch)
            return
        if ch["kind"] == "prefill":
            if ch["toks"] is not None:
                t0 = time.perf_counter()
                try:
                    toks = self._device_call("collect:prefill",
                                             self._host_tokens, ch)
                except _DispatchFailed as e:
                    self.time_prefill_s += time.perf_counter() - t0
                    self._fail_prefill_group(ch["group"], e)
                    self._free_after(ch)
                    return
                self.time_prefill_s += time.perf_counter() - t0
                self._prefill_complete(toks, ch["group"])
            self._free_after(ch)
            return
        t0 = time.perf_counter()
        try:
            toks = self._device_call("collect:decode", self._host_tokens,
                                     ch)
        except _DispatchFailed as e:
            self.time_stall_s += time.perf_counter() - t0
            self._fail_chunk_requests(ch, e)
            self._free_after(ch)
            return
        self.time_stall_s += time.perf_counter() - t0
        now = time.perf_counter()
        self.decode_steps += ch["T"]
        self.decode_slot_steps += ch["T"] * self.max_b
        for si, steps in ch["steps"].items():
            req = ch["reqs"][si]
            if req.state != "running" or req.epoch != ch["epochs"].get(si):
                continue   # retired or preempted while the chunk flew
            self._deliver(req, si, [int(toks[si, t]) for t in range(steps)],
                          now)
        self._free_after(ch)

    def _deliver(self, req: Request, si: int, toks: List[int],
                 now: float) -> int:
        """A decode column's tokens, cut at a mid-chunk EOS; returns how
        many were delivered."""
        delivered = 0
        for tok in toks:
            req.out_tokens.append(tok)
            delivered += 1
            self.generated_tokens += 1
            self._last_tok[si] = tok
            if self._is_finished(req):
                break          # mid-chunk EOS: discard the tail
        self.decode_useful_tokens += delivered
        self._note_itl(req, now, delivered)
        if self._is_finished(req) and self._slots[si] is req:
            self._retire(si)
        return delivered

    def _fail_chunk_requests(self, ch, e: Exception):
        """Fail the live decode columns of an uncollectable chunk."""
        for si, steps in ch["steps"].items():
            req = ch["reqs"][si]
            if steps > 0 and req.state == "running" \
                    and req.epoch == ch["epochs"].get(si) \
                    and self._slots[si] is req:
                self._fail_request(
                    req, f"chunk collection failed after retries: {e}")

    def _fail_prefill_group(self, group, e: Exception):
        """Fail every request of an uncollectable final that still waits
        on it (requests restarted since the dispatch are left alone)."""
        for si, req, epoch in group:
            if req.state == "prefilling" and req.epoch == epoch:
                self._fail_request(
                    req, f"prefill collection failed after retries: {e}")

    def _collect_ragged(self, ch):
        """Deliver one chunk's tokens (one host copy of [T, W]): decode
        columns up to their scheduled ministeps with the mid-chunk EOS
        cut, sampling finals the first token of their request; a
        previous life's cells are dropped by epoch."""
        t0 = time.perf_counter()
        try:
            toks = self._device_call("collect:ragged", self._host_tokens, ch)
        except _DispatchFailed as e:
            self.time_stall_s += time.perf_counter() - t0
            self._fail_chunk_requests(ch, e)
            self._fail_prefill_group(
                [(None, req, epoch) for req, epoch, _, _ in ch["finals"]], e)
            self._free_after(ch)
            return
        self.time_stall_s += time.perf_counter() - t0
        now = time.perf_counter()
        self.decode_steps += ch["T"]
        self.decode_slot_steps += ch["T"] * ch["W"]
        self.decode_useful_tokens += ch["real_rows"]
        for si, steps in ch["steps"].items():
            req = ch["reqs"][si]
            if req.state != "running" or req.epoch != ch["epochs"].get(si):
                continue
            c = ch["cols"][si]
            delivered = self._deliver(
                req, si, [int(toks[t, c]) for t in range(steps)], now)
            if ch["fused"] and delivered < steps:
                # frozen after an EOS inside the window: the rest of the
                # column's ministeps ran as scratch-aimed no-ops
                self.ms_frozen_token_waste += steps - delivered
        for req, epoch, t, c in ch["finals"]:
            self._first_token(req, epoch, int(toks[t, c]), now)
        self._free_after(ch)

    def _first_token(self, req: Request, epoch: int, tok: int, now: float):
        """A sampling final row's token: its request, still in the life
        it was dispatched in, leaves "prefilling"."""
        if req.state != "prefilling" or req.epoch != epoch:
            return
        si = req.slot
        req.state = "running"
        if self.tracer is not None:
            self._trace_running(req, now)
        self._mark_first_token(req, now)
        req.out_tokens.append(tok)
        req.planned = 1
        self.generated_tokens += 1
        self._last_tok[si] = tok
        self._fresh_slots.add(si)
        if self._is_finished(req):
            self._retire(si)

    def _note_itl(self, req: Request, now: float, delivered: int):
        """Inter-token latency: the chunk's wall interval split evenly
        over the tokens it delivered to the request."""
        if not delivered:
            return
        if req.t_last_emit is not None:
            itl = (now - req.t_last_emit) / delivered
            req.itls.extend([itl] * delivered)
            if self.tracer is not None:
                self.tracer.metrics.histogram(
                    "engine.itl_s").observe(itl, n=delivered)
            if self._slo is not None:
                # one weighted sample a chunk: the windows see every
                # delivered token
                self._slo.observe("itl", itl, self._slo_attrs(req),
                                  n=delivered, now=now)
        req.t_last_emit = now

    def step(self) -> bool:
        """One engine iteration: deadlines, admit, dispatch, collect.
        Dense: prefill dispatches, then one decode chunk, then collection
        down to the pipeline depth (one decode chunk stays in flight
        with ``overlap`` unless a running request uses a repetition
        penalty); ragged: the unified chunk(s), all collected. Faults
        are absorbed per request. Returns True while there is work
        left."""
        if self._closed:
            raise RuntimeError("engine is closed")
        with torch.inference_mode():
            self._enforce_deadlines()
            self._admit()
            if self.ragged:
                self._dispatch_ragged()
                depth = 0
            else:
                self._dispatch_prefill()
                dispatched = self._dispatch_chunk()
                depth = 1 if (dispatched and self.overlap
                              and not self._rep_active()) else 0
            while len(self._inflight) > depth:
                self._collect_oldest()
        if self.tracer is not None:
            self._sample_counter_tracks()
        if self._debug_pool:
            self.dec.cache.debug_check()
            if self.lora is not None:
                self._debug_lora_check()
        return self.has_work

    def run_to_completion(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {req_id: generated tokens}."""
        while self.step():
            pass
        return {rid: self.result(rid) for rid in list(self._done)}

    def stats(self) -> dict:
        """Throughput, latency and robustness summary, with JAX's keys and
        definitions. Latency, TTFT and queue-wait percentiles cover
        requests that finished (state done); the ITL percentiles cover
        the finished requests' reservoir and the requests in a slot now
        (aborted and failed lives are left out); quantiles are
        interpolated. ``kv_quant``, ``kv_pool_bytes`` and
        ``kv_bytes_per_token`` describe the pool and survive
        ``clear_finished``."""
        cache = self.dec.cache
        ok = [r for r in self._done.values() if r.state == "done"]
        lats = [r.latency_s for r in ok if r.latency_s is not None]
        ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
        waits = [r.queue_wait_s for r in ok if r.queue_wait_s is not None]
        itls = list(self._itl_res) + [
            x for r in self._slots if r is not None for x in r.itls]

        def pct(xs, p):
            return float(np.quantile(xs, p)) if xs else None

        out = {
            "finished": len(ok),
            "preemptions": self.preemptions,
            "recompute_tokens": self.recompute_tokens,
            "aborted": self.aborted,
            "failed": self.failed,
            "deadline_misses": self.deadline_misses,
            "shed_requests": self.shed_requests,
            "retries": self.retries,
            "dispatch_exhaustions": self.dispatch_exhaustions,
            "generated_tokens": self.generated_tokens,
            "device_dispatches": self.device_dispatches,
            "tokens_per_dispatch": (
                self.generated_tokens / self.device_dispatches
                if self.device_dispatches else 0.0),
            "decode_steps": self.decode_steps,
            "decode_slot_steps": self.decode_slot_steps,
            "decode_useful_tokens": self.decode_useful_tokens,
            "padded_token_waste": (self.decode_slot_steps
                                   - self.decode_useful_tokens),
            "decode_utilization": (
                self.decode_useful_tokens / self.decode_slot_steps
                if self.decode_slot_steps else 0.0),
            "masked_decode_columns": self.masked_decode_columns,
            # speculative decoding: drafts proposed and accepted, windows
            # with a rejected tail, the per-window acceptance EMA (0.1)
            "drafted_tokens": self.drafted_tokens,
            "accepted_draft_tokens": self.accepted_draft_tokens,
            "draft_acceptance_rate": (
                self.accepted_draft_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0),
            "spec_rollbacks": self.spec_rollbacks,
            "draft_acceptance_ema": float(self.draft_acceptance_ema),
            # many-LoRA: adapters pinned now, registry hits / misses /
            # evictions, adapter rows per lora dispatch
            "active_adapters": (self.lora.active_count()
                                if self.lora is not None else 0),
            "adapter_cache_hits": (self.lora.hits
                                   if self.lora is not None else 0),
            "adapter_cache_misses": (self.lora.misses
                                     if self.lora is not None else 0),
            "adapter_cache_evictions": (self.lora.evictions
                                        if self.lora is not None else 0),
            "lora_rows_per_dispatch": (
                self.lora_rows / self.lora_dispatches
                if self.lora_dispatches else 0.0),
            # multi-step: the configured k, windows dispatched, and the
            # ministeps columns spent frozen after an EOS in a window
            "multi_step_k": float(self.multi_step),
            "multi_step_windows": self.ms_windows,
            "ms_frozen_token_waste": self.ms_frozen_token_waste,
            "time_prefill_s": self.time_prefill_s,
            "time_decode_stall_s": self.time_stall_s,
            "time_host_s": self.time_host_s,
            "free_blocks": cache.free_blocks,
            "cached_blocks": cache.cached_blocks,
            # prompt tokens spliced from cached blocks instead of
            # prefilled, over the prompt tokens admitted
            "prefix_cache_hit_tokens": cache.prefix_hit_tokens,
            "prefix_cache_hit_rate": (
                cache.prefix_hit_tokens / cache.prefix_query_tokens
                if cache.prefix_query_tokens else 0.0),
            "prefix_cache_evictions": cache.prefix_evictions,
            # first captures (first eager runs on the CPU) of a program
            # key, and those after seal_programs
            "program_compiles": self.programs.compiles,
            "unexpected_recompiles": self.programs.unexpected,
            "programs_sealed": self.compile_watch.sealed,
            # sampled attribution fences taken (profile_every)
            "profiled_dispatches": self.profiled_dispatches,
            "queued": len(self._queue),
            "latency_p50_s": pct(lats, 0.50),
            "latency_p99_s": pct(lats, 0.99),
            "ttft_p50_s": pct(ttfts, 0.50),
            "ttft_p99_s": pct(ttfts, 0.99),
            "itl_p50_s": pct(itls, 0.50),
            "itl_p99_s": pct(itls, 0.99),
            "queue_wait_p50_s": pct(waits, 0.50),
            # the pool: its storage ("int8" or the plane dtype's name),
            # its bytes (int8 scales included) and bytes per token slot
            "kv_quant": self.kv_quant or cache.pool_dtype,
            # the tensor-parallel degree (a configuration gauge)
            "tp": self.tp,
            "kv_pool_bytes": cache.pool_bytes(),
            "kv_bytes_per_token": cache.bytes_per_token(),
        }
        if self._slo is not None:
            # burn rates and headroom per policy; the scalar minimum
            # headroom is mirrored into the registry like any float
            slo = self._slo.evaluate()
            out["slo"] = slo
            out["slo_min_headroom"] = float(slo["min_headroom"])
            if self.tracer is not None:
                for pname, pol in slo["policies"].items():
                    if pol["violating"] and \
                            pname not in self._slo_violating:
                        self.tracer.event(
                            "slo_violation", pid=self.replica_id,
                            policy=pname, headroom=pol["headroom"])
                self._slo_violating = {
                    pname for pname, pol in slo["policies"].items()
                    if pol["violating"]}
                flat = {}
                for pname, pol in slo["policies"].items():
                    flat[f"{pname}.headroom"] = float(pol["headroom"])
                    for metric, md in pol["metrics"].items():
                        for wname, wd in md["windows"].items():
                            if wd["burn_rate"] is not None:
                                flat[f"{pname}.{metric}.burn_{wname}"] = \
                                    float(wd["burn_rate"])
                self.tracer.metrics.publish(
                    "slo" if self.replica_id == 0
                    else f"slo.r{self.replica_id}", flat)
        if self.tracer is not None:
            # the registry mirrors this dict (ints as counters, floats as
            # gauges); replica r of a fleet publishes under engine{r}
            self.tracer.metrics.publish(
                "engine" if self.replica_id == 0
                else f"engine{self.replica_id}", out)
        return out

    @property
    def program_compiles(self) -> int:
        return self.programs.compiles

    @property
    def unexpected_recompiles(self) -> int:
        return self.programs.unexpected

    # -- warmup and the sealed program set ----------------------------------
    def _warmup_prompt(self, n: int) -> np.ndarray:
        """A throwaway prompt with a fill of its own: two warmup prompts
        never share a block-aligned prefix, so the prefix cache cannot
        splice them together."""
        self._warmup_fill = getattr(self, "_warmup_fill", 0) + 1
        v = 1 + self._warmup_fill % max(1, self.dec.cfg.vocab_size - 1)
        return np.full(n, v, np.int32)

    def warmup(self, prompt_len: Optional[int] = None,
               seal_programs: bool = False):
        """Compile the serving programs with throwaway traffic (JAX's
        ``warmup``, request for request, so it consumes the same keys):
        one request and a burst of ``PREFILL_GROUP`` for every bucket
        (or ``prompt_len``'s), prefix-cache hits at every suffix bucket
        a hit can reach, each decode rung rich (temperature 1.0, top_k
        1) and greedy, and, with several rungs, each rung's cost over
        up to 3 chunks for ``_pick_chunk``. A pool too small for a round
        skips it. The prefix cache and the finished requests' stats are
        cleared afterwards. ``seal_programs=True`` then captures the
        whole reachable grid (``warmup_programs``) and seals it."""
        plens = [prompt_len] if prompt_len is not None \
            else list(self.buckets)
        cache = self.dec.cache
        width = min(self.PREFILL_GROUP, self.max_b)

        def serve(prompts, **sp):
            for p in prompts:
                self.add_request(p, SamplingParams(**sp))
            self.run_to_completion()

        for plen in plens:
            serve([self._warmup_prompt(plen)], max_new_tokens=2)
            if self.max_b >= 2 and cache.available_blocks >= \
                    2 * -(-(plen + 2) // cache.block_size):
                serve([self._warmup_prompt(plen) for _ in range(width)],
                      max_new_tokens=2)
        if self.prefix_caching:
            bs = cache.block_size
            prefix = self._warmup_prompt(bs)
            seeded = burst_done = False
            for b in self.buckets:
                s_suf = min(b, self.buckets[-1] - bs)
                if s_suf <= 0 or _bucket_for(s_suf, self.buckets) != b:
                    continue          # no hit's suffix lands in bucket b
                per_hit = -(-(bs + s_suf + 2) // bs)
                if cache.available_blocks < per_hit + 1:
                    continue
                if not seeded:        # park the shared prefix block
                    serve([np.concatenate([prefix,
                                           self._warmup_prompt(1)])],
                          max_new_tokens=1)
                    seeded = True

                def hits(n):
                    return [np.concatenate([prefix,
                                            self._warmup_prompt(s_suf)])
                            for _ in range(n)]

                serve(hits(1), max_new_tokens=2)
                if not burst_done and self.max_b >= 2 \
                        and cache.available_blocks >= width * per_hit:
                    serve(hits(width), max_new_tokens=2)
                    burst_done = True
        warmed = set()
        for c in self.chunks:
            if -(-(plens[0] + c + 2) // cache.block_size) \
                    > cache.available_blocks:
                continue
            warmed.add(c)
            self._force_chunk = c
            try:
                serve([self._warmup_prompt(plens[0])],
                      max_new_tokens=c + 2, temperature=1.0, top_k=1)
                serve([self._warmup_prompt(plens[0])], max_new_tokens=c + 2)
            finally:
                self._force_chunk = None
        if len(self.chunks) > 1:
            for c in sorted(warmed):
                n_chunks = 3
                while n_chunks > 0 and -(-(plens[0] + n_chunks * c)
                                         // cache.block_size) \
                        > cache.available_blocks:
                    n_chunks -= 1
                if n_chunks == 0:
                    continue
                self._force_chunk = c
                try:
                    before = self.time_stall_s + self.time_host_s
                    serve([self._warmup_prompt(plens[0])],
                          max_new_tokens=n_chunks * c)
                    delta = self.time_stall_s + self.time_host_s - before
                finally:
                    self._force_chunk = None
                self._chunk_cost[c] = max(delta / n_chunks, 1e-6)
        # one request with an adapter runs a lora twin (base traffic
        # never does)
        if self.lora is not None and self.lora.ids():
            need = self.lora.n_pages() \
                + -(-(plens[0] + 2) // cache.block_size)
            if cache.available_blocks >= need:
                serve([self._warmup_prompt(plens[0])], max_new_tokens=2,
                      adapter_id=self.lora.ids()[0])
        # parked warmup blocks and adapter pages go too
        cache.clear_prefix_cache()
        if seal_programs:
            self.warmup_programs()
            self.seal_programs()
        self.clear_finished()

    def reachable_ragged_widths(self, T: int,
                                max_width: Optional[int] = None
                                ) -> List[int]:
        """The W rungs a T-ministep ragged chunk can be dispatched at:
        mixed chunks carry at most max_b decode columns plus
        ceil(prefill budget / T) prefill columns, pure-prefill chunks
        widen to the idle cap, and the sticky width only pads to a width
        already reached at the same T, so the set is closed."""
        cap = self._ragged_cap
        idle = max(cap, self._ragged_idle_cap)
        rows = max(self.max_b + -(-cap // T), -(-idle // T))
        return self._widths_up_to(rows, max_width)

    def _widths_up_to(self, rows: int,
                      max_width: Optional[int] = None) -> List[int]:
        """W rungs (the ladder, then multiples of 64) up to the padded
        width of ``rows`` (at most ``max_width``)."""
        if max_width is not None:
            rows = min(rows, int(max_width))
        bound = self._ragged_width(rows)
        widths = [w for w in self.RAGGED_WIDTHS if w <= bound]
        w = (widths[-1] if widths else 0) + 64
        w -= w % 64
        while w <= bound:
            widths.append(w)
            w += 64
        return widths

    def _spec_widths(self, max_width: Optional[int] = None) -> List[int]:
        """The W rungs of the verify ministep: every running column fans
        out to 1 + draft_len rows, prefill rows fill the budget."""
        rows = self.max_b * (1 + self.spec.draft_len) + self._ragged_cap
        return self._widths_up_to(rows, max_width)

    def warmup_programs(self, max_width: Optional[int] = None):
        """Compile the reachable program grid by direct invocation (JAX's
        ``warmup_programs``): every operand aims at the scratch page and
        row, so no block is claimed and no scheduler state changes, and
        the keys are ``PRNGKey(0)``'s, so the engine key is left alone
        and a warmed engine serves token-identical to a cold one,
        stochastic rows included. Each key is compiled plain and rich,
        greedy and sampled. Dense: the final prefill per (bucket, rows 1
        and PREFILL_GROUP), plain and prefix, the mid chunk at offset 0
        and per prefix-page width, the decode chunk per rung. Ragged:
        the chunk per (T in the rungs and 1, W in
        ``reachable_ragged_widths``) and its lora twins; with
        ``multi_step`` k the windows at T in {k * rung} and their lora
        twins; with spec decode the verify ministep (greedy and sampled;
        spec never runs rich) at every ``_spec_widths`` W, and its lora
        twin. ``max_width`` clamps W (to leave a rung cold on
        purpose)."""
        mb, mp = self.max_b, self.dec.max_pages
        sb, ss = self._scratch_block, self._scratch_slot
        prepare = self.programs.prepare
        f32 = np.float32
        key0 = prng.PRNGKey(0)
        self._mask_planes()
        grid = [(s, r) for s in (False, True) for r in (False, True)]

        def rich_ops(*shape):
            return [np.zeros(shape, np.int32), np.ones(shape, f32),
                    np.ones(shape, f32)]

        with torch.inference_mode():
            if not self.ragged:
                k1 = self._key_operand(key0)
                for b in self.buckets:
                    for w in sorted({1, min(self.PREFILL_GROUP, mb)}):
                        ids = np.zeros((w, b), np.int32)
                        slots = np.full((w, b), ss, np.int32)
                        zeros = np.zeros(w, np.int32)
                        tail = [np.zeros(w, f32), k1]
                        ptab = np.full((w, self._prefix_pages), sb,
                                       np.int32)
                        for sampled, rich in grid:
                            extra = rich_ops(w) if rich else []
                            prepare("prefill", (b, w, sampled, rich),
                                    [ids, slots, zeros] + tail + extra)
                            prepare("prefill_prefix", (b, w, sampled, rich),
                                    [ids, slots, zeros, zeros, ptab] + tail
                                    + extra)
                if self._can_recompute:
                    c = self.prefill_chunk or self._recompute_chunk
                    ids = np.zeros((1, c), np.int32)
                    slots = np.full((1, c), ss, np.int32)
                    prepare("prefill_mid0", (c,), [ids, slots])
                    for pb in self._prefix_page_buckets:
                        prepare("prefill_mid", (c, pb),
                                [ids, slots, np.ones(1, np.int32),
                                 np.full((1, pb), sb, np.int32)])
                for T in self.chunks:
                    zeros = np.zeros(mb, np.int32)
                    sched = [np.full((T, mb, mp), sb, np.int32),
                             np.zeros((T, mb), np.int32),
                             np.full((T, mb), ss, np.int32), zeros, zeros,
                             np.ones(mb, np.int32), np.zeros(mb, f32),
                             self._key_operand(prng.split(key0, T))]
                    for sampled, rich in grid:
                        prepare("decode", (T, sampled, rich),
                                sched + (rich_ops(mb) if rich else []))
                return
            tables = np.full((mb + 1, mp), sb, np.int32)
            lora_ops = [[]]
            if self.lora is not None:
                lora_ops.append([np.full((mb + 1, self.lora.n_pages()), sb,
                                         np.int32)])
            windows = [(T, False) for T in sorted(set(self.chunks) | {1})]
            if self.multi_step > 1:
                windows += [(T, True) for T in sorted(
                    {self.multi_step * c for c in self.chunks})]
            for T, ms in windows:
                keys = self._key_operand(prng.split(key0, T))
                for W in self.reachable_ragged_widths(T, max_width):
                    z = np.zeros((T, W), np.int32)
                    sched = np.stack([z, z, np.full((T, W), ss, np.int32),
                                      np.full((T, W), mb, np.int32), z, z])
                    base = [np.zeros(W, np.int32), sched, tables,
                            np.zeros((T, W), f32), keys]
                    if ms:
                        base.append(np.full(W, -1, np.int32))
                    for lo in lora_ops:
                        for sampled, rich in grid:
                            extra = rich_ops(T, W) \
                                + [np.zeros(W, np.int32)] if rich else []
                            prepare(self._ragged_family(ms, bool(lo)),
                                    (T, W, sampled, rich),
                                    base + lo + extra)
            if self.spec is not None:
                k1 = self._key_operand(key0)
                for W in self._spec_widths(max_width):
                    z = np.zeros(W, np.int32)
                    sched = np.stack([z, z, np.full(W, ss, np.int32),
                                      np.full(W, mb, np.int32), z, z,
                                      np.arange(W, dtype=np.int32), z])
                    base = [sched, z, tables, np.zeros(W, f32), k1]
                    for lo in lora_ops:
                        for sampled in (False, True):
                            prepare("spec_lora" if lo else "spec",
                                    (W, sampled), base + lo)

    def seal_programs(self):
        """Declare the program set complete: from here a program key seen
        for the first time runs eagerly and counts in
        ``stats()["unexpected_recompiles"]``."""
        self.compile_watch.seal()

    def clear_finished(self):
        """Drop finished requests and reset the counters (after warmup),
        the robustness counters and the prefix cache's hit and eviction
        counters included, so stats() reflect only the traffic that
        follows. The program set and its sealed flag stay."""
        self._done.clear()
        self._itl_res = Reservoir(self.ITL_RESERVOIR_K)
        self.decode_steps = 0
        self.generated_tokens = 0
        self.device_dispatches = 0
        self.decode_slot_steps = 0
        self.decode_useful_tokens = 0
        self.masked_decode_columns = 0
        self.preemptions = 0
        self.recompute_tokens = 0
        self.aborted = 0
        self.failed = 0
        self.deadline_misses = 0
        self.shed_requests = 0
        self.retries = 0
        self.dispatch_exhaustions = 0
        self.time_prefill_s = 0.0
        self.time_stall_s = 0.0
        self.time_host_s = 0.0
        self._reset_family_counters()
        self.programs.reset_stats()
        self.dec.cache.reset_prefix_stats()
        self.profiled_dispatches = 0
        if self._slo is not None:
            self._slo.reset()
        self._slo_violating.clear()

    def close(self):
        """Collect anything dispatched, drop the programs, clear the
        prefix index (the decoder outlives the engine) and refuse
        further work. Idempotent."""
        if self._closed:
            return
        with torch.inference_mode():
            while self._inflight:
                self._collect_oldest()
        self.programs.close()
        self.dec.cache.clear_prefix_cache()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
