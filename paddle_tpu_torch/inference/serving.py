"""Continuous-batching serving engine over the paged KV pool — the
ragged path.

Counterpart: ``paddle_tpu/inference/serving.py`` with ``ragged=True``.
Every step is ONE unified chunk: a [T, W] schedule of flattened rows run
as T sequential ministeps of ``PagedLlamaDecoder._ragged_logits``.
Decode columns (one per running request) carry their sampled token from
one ministep to the next on the device; prefill rows (a budget of prompt
tokens per step, spread ministep-major over the columns past the decode
columns) write K/V only, except a prompt's final row, which samples the
request's first token. W is the real row count padded up a rung of
``RAGGED_WIDTHS``; a shrinking W keeps the previous chunk's width while
T is unchanged (the sticky width). Each chunk is collected with one host
copy of its [T, W] tokens before the step returns; keeping a chunk in
flight while the host schedules the next (the JAX ``overlap=True``)
comes later.

Admission is worst-case: a request is admitted only when its prompt plus
``max_new_tokens`` fits the free blocks, so a running request never
exhausts the pool. One scratch page takes the writes of padding rows;
table row ``max_batch_size`` is the scratch row they read.

Sampling is greedy (temperature <= 0) or temperature sampling with an
engine-wide top_k, drawn by Gumbel-max from a ``torch.Generator`` seeded
by ``seed``: the same seed gives the same stream, which is not the JAX
package's threefry stream. Serving runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .paged_decode import PagedLlamaDecoder

__all__ = ["SamplingParams", "Request", "ServingEngine"]


@dataclass
class SamplingParams:
    """Per-request sampling: temperature <= 0 is greedy."""
    temperature: float = 0.0
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None


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
    prefill_sent: int = 0                 # prompt tokens dispatched so far
    slot: Optional[int] = None
    itls: List[float] = field(default_factory=list)
    t_last_emit: Optional[float] = None

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


class ServingEngine:
    """Ragged continuous-batching serving of a ``PagedLlamaDecoder``.

    Usage:
        eng = ServingEngine(dec, max_batch_size=8)
        rid = eng.add_request(prompt_ids, SamplingParams(max_new_tokens=64))
        eng.run_to_completion()
        tokens = eng.result(rid)

    The engine runs on the decoder's device (chosen when the decoder was
    built, ``device=None`` meaning cuda)."""

    # row-count rungs of the [T, W] schedule; W pads up to the next rung
    RAGGED_WIDTHS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
    # prefill rows per pure-prefill chunk on an idle engine
    _RAGGED_IDLE_CAP = 256

    def __init__(self, dec: PagedLlamaDecoder, max_batch_size: int = 8,
                 top_k: int = 0, chunk_size: int = 8,
                 chunk_schedule: Optional[Sequence[int]] = None,
                 seed: int = 0, prefill_chunk: Optional[int] = 256):
        if not isinstance(dec, PagedLlamaDecoder):
            raise TypeError(f"ServingEngine needs a PagedLlamaDecoder, got "
                            f"{type(dec).__name__}")
        self.dec = dec
        self.device = dec.device
        self.max_b = int(max_batch_size)
        self.top_k = int(top_k)
        if chunk_schedule:
            self.chunks = tuple(sorted({max(1, int(c))
                                        for c in chunk_schedule}))
        else:
            self.chunks = (max(1, int(chunk_size)),)
        # prefill tokens folded into one chunk while decodes run
        self._ragged_cap = int(prefill_chunk) if prefill_chunk else 64
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        cache = dec.cache
        # one scratch page: padding rows write here and read nothing (a
        # decoder reused across engines keeps its scratch page)
        if -1 not in cache._tables:
            cache.allocate(-1, 1)
        self._scratch_block = cache._tables[-1][0]
        self._scratch_slot = self._scratch_block * cache.block_size

        self._slots: List[Optional[Request]] = [None] * self.max_b
        self._last_tok = np.zeros(self.max_b, np.int32)
        self._queue: deque = deque()
        self._done: Dict[int, Request] = {}
        self._ids = itertools.count()
        self._inflight: deque = deque()
        # (T, W) of the previous chunk of an unbroken run of dispatching
        # steps: the sticky width keeps W while T is unchanged
        self._prev_shape = None
        self._closed = False
        self.decode_steps = 0
        self.generated_tokens = 0
        self.device_dispatches = 0
        self.decode_slot_steps = 0
        self.decode_useful_tokens = 0

    # -- requests ------------------------------------------------------------
    def add_request(self, prompt, sampling: Optional[SamplingParams] = None
                    ) -> int:
        """Queue a prompt ([len] ids). Returns its request id."""
        if self._closed:
            raise RuntimeError("engine is closed")
        sp = sampling or SamplingParams()
        prompt = _normalize_prompt(prompt)
        if int(sp.max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{sp.max_new_tokens}")
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
        worst case (prompt + max_new_tokens) up front."""
        cache = self.dec.cache
        for si in range(self.max_b):
            if self._slots[si] is not None:
                continue
            if not self._queue:
                break
            req = self._queue[0]
            total = int(req.prompt.size) + req.sampling.max_new_tokens
            if cache.free_blocks < -(-total // cache.block_size):
                break
            cache.allocate(req.req_id, total)
            self._queue.popleft()
            req.state = "prefilling"
            req.slot = si
            req.t_admit = time.perf_counter()
            self._slots[si] = req

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
        # device work is stream-ordered: a page freed here is rewritten
        # only by chunks dispatched later
        self.dec.cache.free(req.req_id)

    def _pick_chunk(self, active) -> int:
        """The ministep count T of this chunk. One rung: that rung.
        Several: queue pressure with EOS-able requests pins the smallest
        (such a slot may free any step); else the largest rung every
        running budget covers when nothing is queued, or the largest the
        soonest-draining slot covers when requests wait."""
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
        T = self._pick_chunk(running) if running else 1
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
            else max(self._ragged_cap, self._RAGGED_IDLE_CAP)
        takes = []
        pending = sorted((r for r in self._slots
                          if r is not None and r.state == "prefilling"
                          and r.prefill_sent < r.prompt.size),
                         key=lambda r: r.req_id)
        for r in pending:
            if budget <= 0:
                break
            take = min(budget, r.prompt.size - r.prefill_sent)
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
                off = req.prefill_sent + j
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

        dev = self.device
        sched = torch.from_numpy(
            np.stack([ids, pos, slots, rseq, rctx, ucar])).to(dev)
        toks = self._ragged_chunk(torch.from_numpy(override).to(dev), sched,
                                  torch.from_numpy(tables).to(dev),
                                  torch.from_numpy(temps).to(dev),
                                  temps > 0.0)
        self.device_dispatches += 1
        for req, n in take_of.values():
            req.prefill_sent += n
        self._inflight.append({
            "toks": toks, "T": T, "W": W, "cols": col_of,
            "steps": steps_of, "reqs": reqs_of, "finals": finals,
            "real_rows": sum(n for _, n in take_of.values())})
        self._prev_shape = (T, W)
        return True

    def _ragged_chunk(self, override, sched, tables, temps, sampled_host):
        """T ragged ministeps. sched [6, T, W] int32 holds ids, positions,
        slots, row_seq, row_ctx and the carry flag; a carry column takes
        the token sampled in the previous ministep (its first from
        ``override``). Returns the sampled tokens [T, W] on the device."""
        dec = self.dec
        cache = dec.cache
        cur = override
        out = []
        for t in range(sched.shape[1]):
            ids = torch.where(sched[5, t] != 0, cur, sched[0, t])
            logits, _, _ = dec._ragged_logits(
                dec.weights, cache.k, cache.v, ids, sched[1, t],
                sched[2, t], sched[3, t], sched[4, t], tables)
            cur = self._sample(logits, temps[t], bool(sampled_host[t].any()))
            out.append(cur)
        return torch.stack(out)

    def _sample(self, logits, temp, any_sampled: bool):
        """Per-row temperature (<= 0: greedy argmax), engine-static top_k,
        Gumbel-max draws from the engine's generator. ``any_sampled`` is
        the host's knowledge that some row has temperature > 0; without
        one no random number is drawn."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not any_sampled:
            return greedy
        if self.top_k > 0:
            kth = logits.topk(self.top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, -1e30), logits)
        t = temp.clamp(min=1e-6)[:, None]
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp(min=torch.finfo(torch.float32).tiny)))
        sampled = (logits / t + gumbel).argmax(dim=-1).to(torch.int32)
        return torch.where(temp > 0.0, sampled, greedy)

    def _collect_ragged(self, ch):
        """Deliver one chunk's tokens (one host copy of [T, W]): decode
        columns up to their scheduled ministeps with the mid-chunk EOS
        cut, sampling finals the first token of their request."""
        toks = ch["toks"].cpu().numpy()
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
        """One engine iteration: admit, dispatch the unified chunk(s),
        collect them. Returns True while there is work left."""
        if self._closed:
            raise RuntimeError("engine is closed")
        with torch.inference_mode():
            self._admit()
            if not self._dispatch_ragged():
                self._prev_shape = None
            while self._inflight:
                self._collect_ragged(self._inflight.popleft())
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
            "padded_token_waste": (self.decode_slot_steps
                                   - self.decode_useful_tokens),
            "free_blocks": cache.free_blocks,
            "queued": len(self._queue),
            "ttft_p50_s": pct(ttfts, 0.50),
            "itl_p50_s": pct(itls, 0.50),
            "itl_p99_s": pct(itls, 0.99),
        }

    def close(self):
        """Collect anything dispatched and refuse further work.
        Idempotent."""
        if self._closed:
            return
        with torch.inference_mode():
            while self._inflight:
                self._collect_ragged(self._inflight.popleft())
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
