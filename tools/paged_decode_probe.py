#!/usr/bin/env python3
"""Quick check of the port's two paged-attention kernels on one CUDA card.

Run from the root of the repository:  python3 tools/paged_decode_probe.py

Builds the kernels, prints ptxas's registers, static shared memory and
spills for ``ragged_paged_attention.cu`` and ``paged_attention_decode.cu``,
each tensor-core kernel's dynamic shared memory and its HMMA / UTMALDG /
UBLKCP counts in the SASS (``chip_smoke._paged_sass``, which fails
without them), then runs ``chip_smoke``'s checks of the ragged kernel
against ``ragged_paged_attention_reference`` on each case of
``chip_smoke.RAGGED_CASES`` and of the decode kernel against
``paged_attention_decode_reference`` on each case of
``chip_smoke.DECODE_CASES`` (the int8-pool case through the dispatcher's
ragged route). One JSON line per case: max abs error, split count, the
kernel's, the plain version's and (rows of one ctx) SDPA's mean ms over
gathered K/V (L2 flushed before each launch), the least time the card
could take and the share of it reached. A case that disagrees, holds a
NaN, a non-zero ctx-0 row or differs between two runs ends the run with
a non-zero exit code. It is the short first call after a kernel change;
chip_smoke.py holds the full checks.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("paged_decode_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    _build.load_library()
    print("build_s", _build.build_info["seconds"], flush=True)
    for src in ("ragged_paged_attention.cu", "paged_attention_decode.cu"):
        print(src, json.dumps(cs._paged_ptxas(
            _build.build_info["ptxas"].get(src, ""))), flush=True)
    print("dynamic_smem", json.dumps(
        {f"<{d},{'int8' if qz else 'bf16'}{',deep' if dp else ''}>":
         rpa.smem_bytes(d, qz, dp) for d in (64, 128)
         for qz in (False, True) for dp in (False, True)}), flush=True)
    sass = cs._sass(_build.BUILD_DIR / _build.build_info["library"])
    print("sass", json.dumps(cs._paged_sass(sass)), flush=True)
    print(cs._smi(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs._Timer(torch)
    keys = ("kernel", "case", "route", "max_abs_err", "plan", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by",
            "share_of_bound")
    for spec in cs.RAGGED_CASES:
        c = cs._ragged_check(torch, gen, timer, spec)
        print(json.dumps({k: c[k] for k in keys if k in c}), flush=True)
        torch.cuda.empty_cache()
    for spec in cs.DECODE_CASES:
        c = cs._decode_check(torch, gen, timer, spec)
        print(json.dumps({k: c[k] for k in keys if k in c}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
