#!/usr/bin/env python3
"""Quick check of the port's paged decode attention kernel on one CUDA card.

Run from the root of the repository:  python3 tools/paged_decode_probe.py

Builds the kernels (printing ptxas's registers, shared memory and spills
for ``paged_attention_decode.cu``), then runs ``chip_smoke``'s check of
the kernel against ``paged_attention_decode_reference`` on each case of
``chip_smoke.DECODE_CASES`` (the int8-pool case through the dispatcher's
ragged route) and prints one JSON line per case: max abs error, the
kernel's and the plain version's mean ms (L2 flushed before each launch)
and the least time the card could take. A case that disagrees ends the
run with a non-zero exit code. It is the short first call after a kernel
change; chip_smoke.py holds the full checks.
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
    _build.load_library()
    print("build_s", _build.build_info["seconds"], flush=True)
    for ln in _build.build_info["ptxas"].get("paged_attention_decode.cu",
                                             "").splitlines():
        if any(w in ln for w in ("Compiling", "registers", "spill")):
            print(ln.strip())
    print(cs._smi(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs._Timer(torch)
    for spec in cs.DECODE_CASES:
        c = cs._decode_check(torch, gen, timer, spec)
        print(json.dumps({k: c[k] for k in (
            "case", "route", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
