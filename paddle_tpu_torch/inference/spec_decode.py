"""Speculative decoding, the drafting half: host-side numpy only.

Counterpart: ``paddle_tpu/inference/spec_decode.py`` (the port keeps its
own copy). A drafter proposes up to ``k`` continuation tokens per greedy
decode column; the engine verifies them as extra rows of one ragged
ministep (``ServingEngine._dispatch_spec_chunk``), accepts the longest
prefix that matches the model's own argmax (``_spec_accept``, shared by
the Llama and GPT decoders) and rolls the allocator back past the rest
(``PagedKVCache.rollback``). Greedy streams are the same with
speculation on or off.

A drafter must be deterministic in its inputs and cheap next to a model
forward; ``propose(history, k)`` sees prompt ++ generated tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["Drafter", "NGramDrafter", "SpecConfig"]


class Drafter:
    """Draft-token source. The engine calls ``propose`` once per
    draftable decode column per step, with exact history."""

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens for ``history`` ([n]
        int32, prompt ++ generated); fewer, or none, is allowed. Must
        not mutate ``history``."""
        raise NotImplementedError

    def observe(self, history: np.ndarray, accepted: int,
                drafted: int) -> None:
        """Feedback after each verify step: drafts accepted of those
        proposed. The default drafter ignores it."""


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: find the history's trailing n-gram at an
    earlier place in the history and propose what followed it there.
    n runs from ``max_ngram`` down to ``min_ngram``; among matches of
    one n the earliest wins (it has the longest continuation)."""

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        max_ngram = int(max_ngram)
        min_ngram = int(min_ngram)
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram} max_ngram={max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)
        empty = np.zeros(0, np.int32)
        n_hi = min(self.max_ngram, h.size - 1)
        if k <= 0 or n_hi < self.min_ngram:
            return empty
        for n in range(n_hi, self.min_ngram - 1, -1):
            pat = h[h.size - n:]
            # every window before the last (which is the pattern itself)
            wins = np.lib.stride_tricks.sliding_window_view(h, n)
            match = np.flatnonzero(
                np.all(wins[:-1] == pat[None, :], axis=1))
            if match.size:
                i = int(match[0])
                cont = h[i + n:i + n + k]
                if cont.size:
                    return cont.astype(np.int32, copy=True)
        return empty


@dataclass
class SpecConfig:
    """``ServingEngine(spec_decode=SpecConfig(...))``: ``draft_len``
    drafts at most per column and verify step (the window is 1 +
    draft_len rows); ``max_ngram`` / ``min_ngram`` configure the default
    ``NGramDrafter``; ``drafter`` replaces it."""
    draft_len: int = 8
    max_ngram: int = 4
    min_ngram: int = 1
    drafter: Optional[Drafter] = None

    def __post_init__(self):
        self.draft_len = int(self.draft_len)
        if self.draft_len < 1:
            raise ValueError(
                f"draft_len must be >= 1, got {self.draft_len}")

    def make_drafter(self) -> Drafter:
        if self.drafter is not None:
            return self.drafter
        return NGramDrafter(self.max_ngram, self.min_ngram)
