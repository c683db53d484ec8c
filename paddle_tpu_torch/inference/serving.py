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
schedules the next. Every chunk's tokens are copied to pinned host
memory behind an event right after its dispatch; waiting on that event
at collection is the only host sync of the dense path.

The RAGGED path (``ragged=True``). Every step is ONE unified chunk: a
[T, W] schedule of flattened rows run as T sequential ministeps of
``PagedLlamaDecoder._ragged_logits``.
Decode columns (one per running request) carry their sampled token from
one ministep to the next on the device; prefill rows (a budget of prompt
tokens per step, spread ministep-major over the columns past the decode
columns) write K/V only, except a prompt's final row, which samples the
request's first token. W is the real row count padded up a rung of
``RAGGED_WIDTHS``; a shrinking W keeps the previous chunk's width while
T is unchanged (the sticky width). Each chunk's [T, W] tokens are copied to pinned host
memory behind an event right after its dispatch, and collected before
the step returns: ``overlap`` applies to the dense path only here.

Admission is worst-case: a request is admitted only when its prompt plus
``max_new_tokens`` fits the blocks it can claim, so a running request
never exhausts the pool. A prompt longer than the largest prompt bucket
is refused at ``add_request`` on both paths, as in JAX. One scratch page
takes the writes of padding rows; table row ``max_batch_size`` is the
scratch row the ragged path's padding rows read.

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
chunk per (T, W, sampled), the dense decode chunk per (T, sampled), the
final prefill per (bucket, rows, sampled), plain and prefix, and the
no-sample mid chunk at offset 0 and per prefix-page width. On the card
each program is a CUDA graph (``cuda_graphs=True``, the default);
``warmup_programs`` captures the whole reachable grid without touching
the pool or the random stream, and ``seal_programs`` closes the set: a
key first seen after it runs eagerly and counts in
``unexpected_recompiles``.

Sampling is greedy (temperature <= 0) or temperature sampling with an
engine-wide top_k, drawn by Gumbel-max from a ``torch.Generator`` seeded
by ``seed``. Whether a program draws is decided per dispatch (every
ministep of a ragged chunk draws when any row of the chunk samples), so
the eager run and the graph give one stream for one seed; that stream is
not the JAX package's threefry stream. Serving runs under
``torch.inference_mode()``.

Not ported yet, each with its ROADMAP queue 1 item: deadlines,
priorities, cancel and preemption (item 2), per-request top_k, top_p,
repetition penalty and allowed-token masks (item 3), LoRA adapters
(item 5) and the tracer (item 8). A request whose ``SamplingParams``
asks for one of them is refused, naming the item; the engine has no
parameter for the others yet.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.telemetry import CompileWatch
from .paged_decode import PagedLlamaDecoder
from .programs import ProgramSet

__all__ = ["SamplingParams", "Request", "ServingEngine"]


@dataclass
class SamplingParams:
    """Per-request sampling: temperature <= 0 is greedy. The other
    fields are the JAX package's; a value other than its default is
    refused at ``add_request`` until its ROADMAP item is ported."""
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


# (field, its default, what it needs): a request that sets one raises
_UNPORTED = (
    ("top_k", None, "per-request top_k is rich sampling (ROADMAP queue 1 "
                    "item 3); use the engine's top_k"),
    ("top_p", 1.0, "top_p is rich sampling (ROADMAP queue 1 item 3)"),
    ("repetition_penalty", 1.0,
     "repetition_penalty is rich sampling (ROADMAP queue 1 item 3)"),
    ("allowed_tokens", None,
     "allowed_tokens masks are rich sampling (ROADMAP queue 1 item 3)"),
    ("deadline_s", None, "deadlines are fault tolerance (ROADMAP queue 1 "
                         "item 2)"),
    ("priority", 0, "priorities serve preemption (ROADMAP queue 1 item 2)"),
    ("adapter_id", None, "LoRA adapters are ROADMAP queue 1 item 5"),
)


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
    state: str = "queued"                 # queued | prefilling | running | done
    planned: int = 0                      # tokens scheduled (prefill final + decode)
    n_cached: int = 0                     # prompt tokens spliced from a cache
    prefill_sent: int = 0                 # prompt tokens dispatched so far
    slot: Optional[int] = None
    itls: List[float] = field(default_factory=list)
    t_last_emit: Optional[float] = None
    # prefix splices: (writer, writer's prefill_sent that covers the
    # spliced blocks) pairs, and this request's own full prompt blocks
    # that readers may splice before this request's rows are dispatched
    deps: List[tuple] = field(default_factory=list)
    pending_blocks: List[int] = field(default_factory=list)

    @property
    def suffix_len(self) -> int:
        """Prompt tokens that must run (past a cached prefix; without
        prefix caching, n_cached is 0 and this is the prompt)."""
        return int(self.prompt.size) - self.n_cached

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit


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


class ServingEngine:
    """Continuous-batching serving of a ``PagedLlamaDecoder``.

    Usage:
        eng = ServingEngine(dec, max_batch_size=8)
        rid = eng.add_request(prompt_ids, SamplingParams(max_new_tokens=64))
        eng.run_to_completion()
        tokens = eng.result(rid)

    ``ragged=False`` (the default, as in JAX) runs the dense per-phase
    scheduler, ``ragged=True`` the unified ragged one. The engine runs on
    the decoder's device (chosen when the decoder was built,
    ``device=None`` meaning cuda). ``cuda_graphs=False`` runs every
    program eagerly on the card too (for comparison with the graphs);
    on the CPU programs always run eagerly."""

    # row-count rungs of the [T, W] schedule; W pads up to the next rung
    RAGGED_WIDTHS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
    # prefill rows per pure-prefill chunk on an idle engine (the default
    # of ``ragged_idle_cap``)
    _RAGGED_IDLE_CAP = 256
    # rows of a grouped dense prefill final (a lone final runs 1 row)
    PREFILL_GROUP = 4

    def __init__(self, dec: PagedLlamaDecoder, max_batch_size: int = 8,
                 top_k: int = 0, chunk_size: int = 8,
                 chunk_schedule: Optional[Sequence[int]] = None,
                 seed: int = 0, prefill_chunk: Optional[int] = 256,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 overlap: bool = True,
                 prefill_budget: Optional[int] = None,
                 ragged: bool = False, prefix_caching: bool = True,
                 ragged_idle_cap: Optional[int] = None,
                 cuda_graphs: bool = True):
        if not isinstance(dec, PagedLlamaDecoder):
            raise TypeError(f"ServingEngine needs a PagedLlamaDecoder, got "
                            f"{type(dec).__name__}")
        self.dec = dec
        self.device = dec.device
        self.ragged = bool(ragged)
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
        # ragged path: prefill tokens folded into one chunk while
        # decodes run
        self._ragged_cap = self.prefill_budget or self.prefill_chunk or 64
        if ragged_idle_cap is not None and int(ragged_idle_cap) < 1:
            raise ValueError(f"ragged_idle_cap must be >= 1, got "
                             f"{ragged_idle_cap}")
        self._ragged_idle_cap = (int(ragged_idle_cap)
                                 if ragged_idle_cap is not None
                                 else self._RAGGED_IDLE_CAP)
        self._force_chunk: Optional[int] = None
        self.prefix_caching = bool(prefix_caching)
        # writers' splice-pending blocks: block -> (writer, its
        # prefill_sent that covers the block)
        self._pending_writes: Dict[int, tuple] = {}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
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
        # prefix is only the chunks before them
        self._prefix_pages = -(-self.buckets[-1] // cache.block_size)
        self._prefix_page_buckets = []
        p = 1
        while p < self._prefix_pages:
            self._prefix_page_buckets.append(p)
            p *= 2
        self._prefix_page_buckets.append(self._prefix_pages)

        self._slots: List[Optional[Request]] = [None] * self.max_b
        self._last_tok = np.zeros(self.max_b, np.int32)
        self._queue: deque = deque()
        self._done: Dict[int, Request] = {}
        self._ids = itertools.count()
        # dispatched, uncollected chunks in device order: "prefill" and
        # "decode" entries (dense), "ragged" entries
        self._inflight: deque = deque()
        # dense: slots (re)filled since the last decode dispatch, whose
        # first token comes from the host
        self._fresh_slots: set = set()
        # (T, W) of the previous chunk of an unbroken run of dispatching
        # steps: the sticky width keeps W while T is unchanged
        self._prev_shape = None
        self._closed = False
        # dense decode: the newest decode chunk's tokens [mb, T], written
        # inside its program, which the next chunk's merge reads
        self._carry = torch.zeros((self.max_b, max(self.chunks)),
                                  dtype=torch.int32, device=self.device)
        self.compile_watch = CompileWatch()
        self.programs = ProgramSet(self.device, gen, self.compile_watch,
                                   graphs=cuda_graphs)
        info = {"decoder": type(dec).__name__, "tp": 1,
                "kv_quant": dec.kv_quant or "none",
                "weight_dtype": dec.weight_dtype or "none"}
        fams = [("prefill", self._final_program),
                ("prefill_prefix", self._final_program),
                ("decode", self._decode_program),
                ("prefill_mid0", self._mid_program),
                ("prefill_mid", self._mid_program)]
        if self.ragged:
            fams.append(("ragged", self._ragged_program))
        for fam, fn in fams:
            self.programs.register(
                fam, fn, preserve=(self._carry,) if fam == "decode" else (),
                **info)
        self.decode_steps = 0
        self.generated_tokens = 0
        self.device_dispatches = 0
        self.decode_slot_steps = 0
        self.decode_useful_tokens = 0
        # wall seconds at the dense path's host call sites: prefill
        # dispatch and collection, waits on decode tokens, and decode
        # scheduling and dispatch
        self.time_prefill_s = 0.0
        self.time_stall_s = 0.0
        self.time_host_s = 0.0

    # -- requests ------------------------------------------------------------
    def _validate_new_request(self, prompt, sp: SamplingParams):
        """Prompt intake and the checks every request passes on both
        paths: the bucket bound, the pool and table geometry, the vocab
        range and the unported sampling fields. Returns the prompt."""
        prompt = _normalize_prompt(prompt)
        for name, default, why in _UNPORTED:
            if getattr(sp, name) != default:
                raise NotImplementedError(f"SamplingParams.{name}: {why}")
        if int(sp.max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{sp.max_new_tokens}")
        _bucket_for(int(prompt.size), self.buckets)   # validates length
        cache = self.dec.cache
        total = int(prompt.size) + int(sp.max_new_tokens)
        need = -(-total // cache.block_size)
        if need > cache.num_blocks - 1:       # -1: the scratch page
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{cache.num_blocks - 1}; shrink max_new_tokens/prompt or "
                f"grow num_blocks")
        if need > self.dec.max_pages:
            raise ValueError(
                f"request needs {need} KV pages but a block table holds "
                f"{self.dec.max_pages}")
        vocab = self.dec.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt ids must lie in [0, {vocab})")
        return prompt

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None
                    ) -> int:
        """Queue a prompt ([len] ids). Returns its request id."""
        if self._closed:
            raise RuntimeError("engine is closed")
        sp = sampling or SamplingParams()
        prompt = self._validate_new_request(prompt, sp)
        rid = next(self._ids)
        self._queue.append(Request(rid, prompt, sp,
                                   t_submit=time.perf_counter()))
        return rid

    def result(self, req_id: int) -> np.ndarray:
        """Generated tokens (prompt excluded) of a finished request."""
        return np.asarray(self._done[req_id].out_tokens, np.int32)

    def request(self, req_id: int) -> Request:
        return self._done[req_id]

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._inflight)
                or any(r is not None for r in self._slots))

    # -- scheduler -----------------------------------------------------------
    def _admit(self):
        """Claim free slots for queued requests, FIFO, reserving the whole
        worst case (prompt + max_new_tokens) up front, net of the blocks
        a prefix splice reuses. With prefix caching the capacity check
        happens inside ``allocate_with_prefix`` before any mutation, so a
        refusal leaves the pool untouched; a spliced block that a writer
        has not dispatched yet becomes a dependency (``_deps_ready``),
        and the request's own full prompt blocks become splice-pending
        until its dispatches cover them."""
        cache = self.dec.cache
        for si in range(self.max_b):
            if self._slots[si] is not None:
                continue
            if not self._queue:
                break
            req = self._queue[0]
            total = int(req.prompt.size) + req.sampling.max_new_tokens
            if self.prefix_caching:
                try:
                    reused, n_cached = cache.allocate_with_prefix(
                        req.req_id, req.prompt, total)
                except RuntimeError:
                    break
                req.deps = [self._pending_writes[b] for b in reused
                            if b in self._pending_writes]
                table = cache.seq_blocks(req.req_id)
                bs = cache.block_size
                for j in range(len(reused), int(req.prompt.size) // bs):
                    self._pending_writes[table[j]] = \
                        (req, (j + 1) * bs - n_cached)
                    req.pending_blocks.append(table[j])
            else:
                if cache.free_blocks < -(-total // cache.block_size):
                    break
                cache.allocate(req.req_id, total)
                n_cached = 0
            self._queue.popleft()
            req.n_cached = n_cached
            req.state = "prefilling"
            req.slot = si
            req.t_admit = time.perf_counter()
            self._slots[si] = req

    def _deps_ready(self, req: Request) -> bool:
        """True when every writer whose blocks ``req`` spliced has
        dispatched the rows covering them; met dependencies are
        dropped."""
        if req.deps:
            req.deps = [(w, need) for w, need in req.deps
                        if w.prefill_sent < need]
        return not req.deps

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
        self._done[req.req_id] = req
        self._slots[si] = None
        if self._inflight:
            # a chunk still in flight was dispatched assuming the request
            # continues and writes its pages: free them when the newest
            # one is collected, as JAX does (the device would order the
            # writes anyway; the deferral keeps admission in step with
            # the reference)
            self._inflight[-1]["free_after"].append(req.req_id)
        else:
            self.dec.cache.free(req.req_id)

    def _pick_chunk(self, active) -> int:
        """The ministep count T of this chunk. One rung: that rung.
        Several: queue pressure with EOS-able requests pins the smallest
        (such a slot may free any step); else the largest rung every
        running budget covers when nothing is queued, or the largest the
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

    def _ragged_plan(self):
        """(T, dcols, takes): this step's decode columns (slot, request,
        ministeps) and prefill takes (request, tokens), computed without
        touching the allocator."""
        running = [si for si in range(self.max_b)
                   if self._slots[si] is not None
                   and self._slots[si].state == "running"]
        T = self._force_chunk or (self._pick_chunk(running) if running
                                  else 1)
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
        return T, dcols, takes

    def _dispatch_ragged(self) -> bool:
        """Dispatch this step's unified chunk; with no running decode (cold
        start, burst admission) keep dispatching prefill-only chunks until
        no prompt token is left to send."""
        if not self._dispatch_ragged_chunk():
            return False
        while (not any(r is not None and r.state == "running"
                       for r in self._slots)
               and self._dispatch_ragged_chunk()):
            pass
        return True

    def _dispatch_ragged_chunk(self) -> bool:
        """Build and run ONE unified chunk: decode columns first (their
        tokens carried ministep to ministep on the device), then this
        step's prefill tokens ministep-major over the remaining columns
        (a row lands at the same or a later ministep than every earlier
        row of its request, and pool writes precede attention inside a
        ministep, so row_ctx alone keeps the chunk causal). Returns True
        when a chunk ran."""
        cache = self.dec.cache
        mp = self.dec.max_pages
        T, dcols, takes = self._ragged_plan()
        if not dcols and not takes:
            return False
        ptotal = sum(t for _, t in takes)
        W = self._ragged_width(len(dcols)
                               + (-(-ptotal // T) if ptotal else 0))
        prev = self._prev_shape
        if prev is not None and prev[0] == T and W < prev[1]:
            W = prev[1]        # sticky width: a shrink keeps the width

        scratch_row = self.max_b
        ids = np.zeros((T, W), np.int32)
        pos = np.zeros((T, W), np.int32)
        slots = np.full((T, W), self._scratch_slot, np.int32)
        rseq = np.full((T, W), scratch_row, np.int32)
        rctx = np.zeros((T, W), np.int32)
        ucar = np.zeros((T, W), np.int32)
        temps = np.zeros((T, W), np.float32)
        override = np.zeros(W, np.int32)
        col_of: Dict[int, int] = {}
        steps_of: Dict[int, int] = {}
        reqs_of: Dict[int, Request] = {}
        take_of: Dict[int, tuple] = {}
        finals: List[tuple] = []

        col = 0
        for si, req, steps in dcols:
            for t in range(steps):
                ctx = cache.context_len(req.req_id)
                slots[t, col] = cache.extend(req.req_id)
                pos[t, col] = ctx
                rctx[t, col] = ctx + 1
                rseq[t, col] = si
            req.planned += steps
            ucar[:, col] = 1
            temps[:, col] = req.sampling.temperature
            override[col] = self._last_tok[si]
            col_of[si] = col
            steps_of[si] = steps
            reqs_of[si] = req
            col += 1

        pcells = [(t, c) for t in range(T) for c in range(col, W)]
        pi = 0
        for req, take in takes:
            si = req.slot
            scheduled = 0
            for j in range(take):
                if pi >= len(pcells):
                    break
                off = req.n_cached + req.prefill_sent + j
                t, c = pcells[pi]
                is_final = off + 1 == req.prompt.size
                if is_final:
                    # at most one sampling final per column
                    while any(fc == c for _, _, fc in finals):
                        pi += 1
                        if pi >= len(pcells):
                            break
                        t, c = pcells[pi]
                    if pi >= len(pcells):
                        break
                slots[t, c] = cache.extend(req.req_id)
                ids[t, c] = int(req.prompt[off])
                pos[t, c] = off
                rctx[t, c] = off + 1
                rseq[t, c] = si
                scheduled += 1
                pi += 1
                if is_final:
                    temps[t, c] = req.sampling.temperature
                    finals.append((req, t, c))
            if scheduled:
                take_of[req.req_id] = (req, scheduled)

        # one table row per slot plus the scratch row at max_b; after the
        # extends above every block list is final for the whole chunk
        tables = np.full((self.max_b + 1, mp), self._scratch_block,
                         np.int32)
        for req in list(reqs_of.values()) + [r for r, _ in take_of.values()]:
            tables[req.slot] = cache.block_table(req.req_id, mp)

        sampled = bool((temps > 0.0).any())
        toks, = self.programs.run(
            "ragged", (T, W, sampled),
            [override, np.stack([ids, pos, slots, rseq, rctx, ucar]),
             tables, temps])
        host, ev = self._to_host(toks)
        self.device_dispatches += 1
        for req, n in take_of.values():
            req.prefill_sent += n
            if req.prefill_sent >= req.suffix_len:
                self._clear_pending_writes(req)
        self._inflight.append({
            "kind": "ragged", "free_after": [], "host": host, "event": ev,
            "T": T, "W": W, "cols": col_of,
            "steps": steps_of, "reqs": reqs_of, "finals": finals,
            "real_rows": sum(n for _, n in take_of.values())})
        self._prev_shape = (T, W)
        return True

    # -- the program families (inference/programs.py) ------------------------
    def _ragged_program(self, key, override, sched, tables, temps):
        """The ragged chunk, key (T, W, sampled): T ministeps. sched [6,
        T, W] int32 holds ids, positions, slots, row_seq, row_ctx and the
        carry flag; a carry column takes the token sampled in the
        previous ministep (its first from ``override`` [W]); tables
        [max_b + 1, max_pages]; temps [T, W]. Every ministep draws when
        ``sampled``. Returns (tokens [T, W],)."""
        _, _, sampled = key
        dec = self.dec
        cache = dec.cache
        cur = override
        out = []
        for t in range(sched.shape[1]):
            ids = torch.where(sched[5, t] != 0, cur, sched[0, t])
            logits, _, _ = dec._ragged_logits(
                dec.weights, cache.k, cache.v, ids, sched[1, t],
                sched[2, t], sched[3, t], sched[4, t], tables)
            cur = self._sample(logits, temps[t], sampled)
            out.append(cur)
        return (torch.stack(out),)

    def _decode_program(self, key, tables, ctx, slots, last_idx, over,
                        use_host, temps):
        """The dense decode chunk, key (T, sampled): first tokens merged
        from the previous chunk's tokens in ``_carry`` (at each slot's
        ``last_idx``) or the host's ``over`` where ``use_host``, then T
        steps over tables [T, mb, max_pages], ctx / slots [T, mb], temps
        [mb]. The tokens [mb, T] are also written to ``_carry``. Returns
        (tokens,)."""
        T, sampled = key
        rows = torch.arange(self.max_b, device=over.device)
        first = torch.where(use_host != 0, over,
                            self._carry[rows, last_idx.long()])
        dec = self.dec
        toks, _, _ = dec._decode_scan_impl(
            dec.weights, dec.cache.k, dec.cache.v, first, tables, ctx, slots,
            sample=lambda lg: self._sample(lg, temps, sampled))
        self._carry[:, :T].copy_(toks)
        return (toks,)

    def _final_program(self, key, ids, slots, last_idx, *rest):
        """A dense final prefill, key (bucket, rows, sampled): ids / slots
        [rows, bucket], last_idx and temps [rows]; the prefix family
        takes n_cached [rows] and prefix tables [rows, prefix_pages]
        before temps. Returns (first tokens [rows],)."""
        sampled = key[2]
        dec = self.dec
        cache = dec.cache
        if len(rest) == 3:
            ncv, ptab, temps = rest
            logits, _, _ = dec._prefill_prefix_impl(
                dec.weights, cache.k, cache.v, ids, slots, last_idx, ncv,
                ptab)
        else:
            temps, = rest
            logits, _, _ = dec._prefill_impl(dec.weights, cache.k, cache.v,
                                             ids, slots, last_idx)
        return (self._sample(logits, temps, sampled),)

    def _mid_program(self, key, ids, slots, *prefix):
        """A no-sample mid chunk, ids / slots [1, prefill_chunk]: at
        offset 0 (key (chunk,)) through ``_prefill_impl``, or with the
        offset [1] and the prefix table [1, width] (key (chunk, width))
        through ``_prefill_prefix_impl``. Writes K/V only."""
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

    def _sample(self, logits, temp, any_sampled: bool):
        """Per-row temperature (<= 0: greedy argmax), engine-static top_k,
        Gumbel-max draws from the engine's generator. ``any_sampled``,
        static for a program, says some row of the dispatch has
        temperature > 0; without one no random number is drawn."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not any_sampled:
            return greedy
        if self.top_k > 0:
            kth = logits.topk(self.top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, -1e30), logits)
        t = temp.clamp(min=1e-6)[:, None]
        u = torch.rand(logits.shape, generator=self.programs.generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp(min=torch.finfo(torch.float32).tiny)))
        sampled = (logits / t + gumbel).argmax(dim=-1).to(torch.int32)
        return torch.where(temp > 0.0, sampled, greedy)

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
        everything ready. A remainder longer than ``prefill_chunk`` goes
        out as a width-1 mid chunk; a remainder that fits one dispatch
        is a final, grouped with the other ready finals of its bucket
        (closing a group early when it crosses the budget)."""
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
            return (self.prefill_chunk is not None
                    and r.suffix_len - r.prefill_sent > self.prefill_chunk)

        spent = 0
        while True:
            ready = [r for r in pending if r.prefill_sent < r.suffix_len
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
        """Dispatch ONE no-sample prefill chunk of exactly
        ``prefill_chunk`` tokens (width 1) at offset n_cached +
        prefill_sent; the pages before it ride along as a scratch-padded
        prefix table whose width is the next power-of-two rung. Returns
        the tokens dispatched."""
        t0 = time.perf_counter()
        cache = self.dec.cache
        c = self.prefill_chunk
        off = req.n_cached + req.prefill_sent
        take = min(c, req.suffix_len - req.prefill_sent)
        ids = np.zeros((1, c), np.int32)
        ids[0, :take] = req.prompt[off:off + take]
        slots = np.full((1, c), self._scratch_slot, np.int32)
        for j in range(take):
            slots[0, j] = cache.extend(req.req_id)
        if off:
            need = -(-off // cache.block_size)
            width = next(b for b in self._prefix_page_buckets if b >= need)
            ptab = np.full((1, width), self._scratch_block, np.int32)
            pb = cache.seq_blocks(req.req_id)[:need]
            ptab[0, :len(pb)] = pb
            self.programs.run("prefill_mid", (c, width),
                              [ids, slots, np.asarray([off], np.int32),
                               ptab])
        else:
            self.programs.run("prefill_mid0", (c,), [ids, slots])
        self.device_dispatches += 1
        req.prefill_sent += take
        self._inflight.append({"kind": "prefill", "toks": None,
                               "group": [], "free_after": []})
        self.time_prefill_s += time.perf_counter() - t0
        return take

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
        for row, (_si, req, off) in enumerate(group):
            n = int(req.prompt.size) - off
            ids[row, :n] = req.prompt[off:]
            slots[row, :n] = [cache.extend(req.req_id) for _ in range(n)]
            last_idx[row] = n - 1
            ncv[row] = off
            if off:
                pb = cache.seq_blocks(req.req_id)[
                    : -(-off // cache.block_size)]
                ptab[row, :len(pb)] = pb
            temps[row] = req.sampling.temperature
        key = (bucket, gp, bool((temps > 0.0).any()))
        if any(off for _, _, off in group):
            toks, = self.programs.run("prefill_prefix", key,
                                      [ids, slots, last_idx, ncv, ptab,
                                       temps])
        else:
            toks, = self.programs.run("prefill", key,
                                      [ids, slots, last_idx, temps])
        host, ev = self._to_host(toks)
        self.device_dispatches += 1
        for _si, req, _off in group:
            req.prefill_sent = req.suffix_len
            self._clear_pending_writes(req)
        self._inflight.append({"kind": "prefill", "toks": toks,
                               "host": host, "event": ev,
                               "group": [(si, req) for si, req, _ in group],
                               "free_after": []})
        self.time_prefill_s += time.perf_counter() - t0

    def _prefill_complete(self, toks: np.ndarray, group):
        """A collected final: each request leaves "prefilling" with its
        first token."""
        now = time.perf_counter()
        for row, (si, req) in enumerate(group):
            if req.state != "prefilling":
                continue
            tok = int(toks[row])
            req.state = "running"
            req.t_first_token = now
            req.t_last_emit = now
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
        from the host. Returns True when a chunk was dispatched."""
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
        steps_of: Dict[int, int] = {}
        reqs_of: Dict[int, Request] = {}
        for si in active:
            req = self._slots[si]
            sp = req.sampling
            # the budget at DISPATCH time: tokens planned, not fetched
            steps = max(0, min(T, sp.max_new_tokens - req.planned))
            for t in range(steps):
                ctx[t, si] = cache.context_len(req.req_id)
                slots[t, si] = cache.extend(req.req_id)
            req.planned += steps
            steps_of[si] = steps
            reqs_of[si] = req
            temps[si] = sp.temperature
            # after the extends the block list is final for the chunk
            tables[:, si, :] = cache.block_table(req.req_id, mp)[None]
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
                        and prev["reqs"].get(si) is req):
                    use_host[si] = 0
                    last_idx[si] = psteps - 1
        self._fresh_slots.clear()
        if prev is not None:
            self.device_dispatches += 1      # the merge (JAX's own program)
        toks, = self.programs.run(
            "decode", (T, bool((temps > 0.0).any())),
            [tables, ctx, slots, last_idx, self._last_tok.astype(np.int32),
             use_host, temps])
        host, ev = self._to_host(toks)
        self.device_dispatches += 1
        self._inflight.append({"kind": "decode",
                               "host": host, "event": ev,
                               "steps": steps_of, "reqs": reqs_of,
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
        through ``_collect_ragged``."""
        ch = self._inflight.popleft()
        if ch["kind"] == "ragged":
            self._collect_ragged(ch)
            return
        if ch["kind"] == "prefill":
            if ch["toks"] is not None:
                t0 = time.perf_counter()
                toks = self._host_tokens(ch)
                self.time_prefill_s += time.perf_counter() - t0
                self._prefill_complete(toks, ch["group"])
            self._free_after(ch)
            return
        t0 = time.perf_counter()
        toks = self._host_tokens(ch)
        self.time_stall_s += time.perf_counter() - t0
        now = time.perf_counter()
        self.decode_steps += ch["T"]
        self.decode_slot_steps += ch["T"] * self.max_b
        for si, steps in ch["steps"].items():
            req = ch["reqs"][si]
            if req.state != "running":
                continue   # retired while the chunk flew
            delivered = 0
            for t in range(steps):
                tok = int(toks[si, t])
                req.out_tokens.append(tok)
                delivered += 1
                self.generated_tokens += 1
                self._last_tok[si] = tok
                if self._is_finished(req):
                    break      # mid-chunk EOS: discard the tail
            self.decode_useful_tokens += delivered
            self._note_itl(req, now, delivered)
            if self._is_finished(req) and self._slots[si] is req:
                self._retire(si)
        self._free_after(ch)

    def _collect_ragged(self, ch):
        """Deliver one chunk's tokens (one host copy of [T, W]): decode
        columns up to their scheduled ministeps with the mid-chunk EOS
        cut, sampling finals the first token of their request."""
        toks = self._host_tokens(ch)
        now = time.perf_counter()
        self.decode_steps += ch["T"]
        self.decode_slot_steps += ch["T"] * ch["W"]
        self.decode_useful_tokens += ch["real_rows"]
        for si, steps in ch["steps"].items():
            req = ch["reqs"][si]
            if req.state != "running":
                continue
            c = ch["cols"][si]
            delivered = 0
            for t in range(steps):
                tok = int(toks[t, c])
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
        for req, t, c in ch["finals"]:
            if req.state != "prefilling":
                continue
            si = req.slot
            tok = int(toks[t, c])
            req.state = "running"
            req.t_first_token = now
            req.t_last_emit = now
            req.out_tokens.append(tok)
            req.planned = 1
            self.generated_tokens += 1
            self._last_tok[si] = tok
            if self._is_finished(req):
                self._retire(si)
        self._free_after(ch)

    def _note_itl(self, req: Request, now: float, delivered: int):
        """Inter-token latency: the chunk's wall interval split evenly
        over the tokens it delivered to the request."""
        if not delivered:
            return
        if req.t_last_emit is not None:
            req.itls.extend([(now - req.t_last_emit) / delivered]
                            * delivered)
        req.t_last_emit = now

    def step(self) -> bool:
        """One engine iteration: admit, dispatch, collect. Dense: prefill
        dispatches, then one decode chunk, then collection down to the
        pipeline depth (one decode chunk stays in flight with
        ``overlap``); ragged: the unified chunk(s), all collected.
        Returns True while there is work left."""
        if self._closed:
            raise RuntimeError("engine is closed")
        with torch.inference_mode():
            self._admit()
            if self.ragged:
                if not self._dispatch_ragged():
                    self._prev_shape = None
                depth = 0
            else:
                self._dispatch_prefill()
                dispatched = self._dispatch_chunk()
                depth = 1 if (dispatched and self.overlap) else 0
            while len(self._inflight) > depth:
                self._collect_oldest()
        return self.has_work

    def run_to_completion(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {req_id: generated tokens}."""
        while self.step():
            pass
        return {rid: self.result(rid) for rid in list(self._done)}

    def stats(self) -> dict:
        """Throughput and latency summary over finished requests."""
        cache = self.dec.cache
        ok = [r for r in self._done.values() if r.state == "done"]
        ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
        itls = [x for r in ok for x in r.itls]

        def pct(xs, p):
            return float(np.quantile(xs, p)) if xs else None

        return {
            "finished": len(ok),
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
            "queued": len(self._queue),
            "ttft_p50_s": pct(ttfts, 0.50),
            "itl_p50_s": pct(itls, 0.50),
            "itl_p99_s": pct(itls, 0.99),
        }

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
        ``warmup``): one request and a burst of ``PREFILL_GROUP`` for
        every bucket (or ``prompt_len``'s), prefix-cache hits at every
        suffix bucket a hit can reach, and each decode rung greedy and
        sampled. A pool too small for a round skips it. The prefix cache
        and the finished requests' stats are cleared afterwards.
        ``seal_programs=True`` then captures the whole reachable grid
        (``warmup_programs``) and seals it. The traffic draws from the
        engine's generator; ``warmup_programs`` alone does not."""
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
        for c in self.chunks:
            if -(-(plens[0] + c + 2) // cache.block_size) \
                    > cache.available_blocks:
                continue
            self._force_chunk = c
            try:
                serve([self._warmup_prompt(plens[0])],
                      max_new_tokens=c + 2, temperature=1.0)
                serve([self._warmup_prompt(plens[0])], max_new_tokens=c + 2)
            finally:
                self._force_chunk = None
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

    def warmup_programs(self, max_width: Optional[int] = None):
        """Compile the reachable program grid by direct invocation (JAX's
        ``warmup_programs``): every operand aims at the scratch page and
        row, so no block is claimed and no scheduler state changes, and
        the compiles draw from a scratch generator, so a warmed engine
        serves token-identical to a cold one, stochastic rows included.
        Dense: the final prefill per (bucket, rows 1 and PREFILL_GROUP,
        sampled), plain and prefix, the mid chunk at offset 0 and per
        prefix-page width, the decode chunk per (rung, sampled). Ragged:
        the chunk per (T in the rungs and 1, W in
        ``reachable_ragged_widths``, sampled); ``max_width`` clamps W
        (to leave a rung cold on purpose)."""
        mb, mp = self.max_b, self.dec.max_pages
        sb, ss = self._scratch_block, self._scratch_slot
        prepare = self.programs.prepare
        f32 = np.float32
        with torch.inference_mode():
            if not self.ragged:
                for b in self.buckets:
                    for w in sorted({1, min(self.PREFILL_GROUP, mb)}):
                        ids = np.zeros((w, b), np.int32)
                        slots = np.full((w, b), ss, np.int32)
                        zeros = np.zeros(w, np.int32)
                        temps = np.zeros(w, f32)
                        ptab = np.full((w, self._prefix_pages), sb,
                                       np.int32)
                        for sampled in (False, True):
                            prepare("prefill", (b, w, sampled),
                                    [ids, slots, zeros, temps])
                            prepare("prefill_prefix", (b, w, sampled),
                                    [ids, slots, zeros, zeros, ptab, temps])
                if self.prefill_chunk:
                    c = self.prefill_chunk
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
                             np.ones(mb, np.int32), np.zeros(mb, f32)]
                    for sampled in (False, True):
                        prepare("decode", (T, sampled), sched)
                return
            tables = np.full((mb + 1, mp), sb, np.int32)
            for T in sorted(set(self.chunks) | {1}):
                for W in self.reachable_ragged_widths(T, max_width):
                    z = np.zeros((T, W), np.int32)
                    sched = np.stack([z, z, np.full((T, W), ss, np.int32),
                                      np.full((T, W), mb, np.int32), z, z])
                    for sampled in (False, True):
                        prepare("ragged", (T, W, sampled),
                                [np.zeros(W, np.int32), sched, tables,
                                 np.zeros((T, W), f32)])

    def seal_programs(self):
        """Declare the program set complete: from here a program key seen
        for the first time runs eagerly and counts in
        ``stats()["unexpected_recompiles"]``."""
        self.compile_watch.seal()

    def clear_finished(self):
        """Drop finished requests and reset the counters (after warmup),
        the prefix cache's hit and eviction counters included, so stats()
        reflect only the traffic that follows. The program set and its
        sealed flag stay."""
        self._done.clear()
        self.decode_steps = 0
        self.generated_tokens = 0
        self.device_dispatches = 0
        self.decode_slot_steps = 0
        self.decode_useful_tokens = 0
        self.time_prefill_s = 0.0
        self.time_stall_s = 0.0
        self.time_host_s = 0.0
        self.programs.reset_stats()
        self.dec.cache.reset_prefix_stats()

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
