"""The compile ledger of the serving programs and the bounded sample of
the engine's ITL stream. Counterparts: ``paddle_tpu/utils/telemetry.py``
``CompileWatch`` and ``Reservoir`` (:117-160); the tracer, the metrics
registry and the SLO monitor come with ROADMAP queue 1 item 8.

In JAX a serving program compiles the first time a shape reaches it,
and the watch reads that off the jit cache. In the port a program is
one CUDA graph per static key (``inference/programs.py``), so a
"compile" is the first capture of a key on the card, or the first eager
run of a key on the CPU. ``seal()`` declares the set complete: a key
first seen after it counts as an unexpected recompile.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["CompileWatch", "Reservoir"]


class Reservoir:
    """Seeded Algorithm-R reservoir: a bounded uniform sample of an
    unbounded stream. Exact (every item kept, in order) while the stream
    holds at most ``k`` items; past that each item seen is kept with
    probability k/n. The same seed and stream give the same sample (the
    RNG is private, so no key stream of the engine moves)."""

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

    def extend(self, xs):
        for x in xs:
            self.append(x)

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)


class CompileWatch:
    """Per-family ledger of program keys seen, and the sealed-set
    sentinel. ``records`` holds one dict per compile: family, shape
    signature, wall seconds, whether the set was sealed, and the
    family's registration info."""

    MAX_RECORDS = 512

    def __init__(self):
        self.sealed = False
        self.compiles = 0
        self.unexpected_recompiles = 0
        self.records: List[dict] = []
        self._families: Dict[str, dict] = {}

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
        rec = {"family": family, "key": key,
               "signature": self.signature_of(args),
               "wall_s": max(0.0, float(t1) - float(t0)),
               "sealed": self.sealed}
        rec.update(fam["info"])
        self.compiles += 1
        if len(self.records) < self.MAX_RECORDS:
            self.records.append(rec)
        unexpected = int(self.sealed)
        self.unexpected_recompiles += unexpected
        return 1, unexpected

    def seal(self):
        """Declare the program set complete."""
        self.sealed = True
