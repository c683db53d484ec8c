#!/usr/bin/env python3
"""Quick check of the port's decode_matmul kernels and the split dk/dv
backward block on one CUDA card.

Run from the root of the repository:  python3 tools/decode_matmul_probe.py [DIR]

Builds the kernels and prints ptxas's registers and spills of every
decode_matmul instantiation, the HMMA count of each tensor-core one in
the library's SASS, and the registers a thread of the six Hopper flash
kernels (168 needed). Then, one JSON line each:
- decode_matmul at the Llama-3-8B shapes (int4 halves at b 1/4/8/32,
  int8 and dense bf16 on wgu at b 1/8/32, one float32 int4 case): the
  relative max error against decode_matmul_reference (< 2e-2), its time
  with the L2 flushed, torch.matmul's on the bf16 dequantized weight, and
  the byte bound (3.35 TB/s);
- flash_attention_bwd_block at the sep-4 ring's shard shapes (diagonal,
  earlier, later): pieces of the dk/dv list, dq and dk/dv times apart,
  the aten flash SDPA backward's, relative errors against the plain
  version and whether two runs are bit-identical.
With DIR, the ptxas report of decode_matmul.cu and the SASS go there.
It is the short first call after a change to these kernels;
chip_smoke.py holds the full checks.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("decode_matmul_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import decode_matmul as dmm
    from paddle_tpu_torch.ops.cuda import flash_attention as cfa
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    print("build_s", _build.build_info["seconds"], flush=True)
    report = _build.build_info["ptxas"].get("decode_matmul.cu", "")
    for name, lines in cs._gemv_ptxas(report).items():
        print(name, lines, flush=True)
    lib_path = _build.BUILD_DIR / _build.build_info["library"]
    sass = cs._sass(lib_path)
    print("gemv_sass", json.dumps(cs._count_sass(
        sass, lambda m: cs._gemv_name(m) if "tc_kernel" in m else None,
        ("HMMA",))), flush=True)
    print("flash_regs", json.dumps({f"{k}<{d}>": cfa.kernel_regs(k, d)
                                    for k in ("fwd", "dq", "dkv")
                                    for d in (64, 128)}), flush=True)
    if len(sys.argv) > 1:
        out_dir = Path(sys.argv[1])
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "ptxas_gemv.txt").write_text(report)
        (out_dir / "sass.txt").write_text(sass)

    timer = cs._Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failed = False
    for kind, names, bs in (("int4_halves", list(cs.SHAPES_8B),
                             (1, 4, 8, 32)),
                            ("int8", ["wgu"], (1, 8, 32)),
                            ("dense", ["wgu"], (1, 8, 32)),
                            ("int4_halves_f32", ["wo"], (8,))):
        for name in names:
            for b in bs:
                try:
                    c = cs._gemv_case(torch, gen, timer, dmm, kind, name, b)
                except RuntimeError as e:  # report it, go on to the rest
                    print("FAILED", kind, name, b, e, flush=True)
                    failed = True
                    continue
                print(json.dumps({k: c[k] for k in (
                    "kind", "shape", "b", "rel_err", "ms", "library_ms",
                    "bound_ms", "share_of_bound", "splits")}), flush=True)
    # device time of each kernel of one call (the L2 flushed before it)
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.qweight import QWeight
    for name, b in (("wo", 8), ("wgu", 8), ("wo", 32), ("wqkv", 32),
                    ("wgu", 32), ("head", 8)):
        K, N = cs.SHAPES_8B[name]
        x = torch.randn((b, K), device="cuda").to(torch.bfloat16)
        w = QWeight(torch.randint(-128, 128, (K // 2, N), device="cuda")
                    .to(torch.int8), torch.rand(N, device="cuda"),
                    "int4_halves")
        dmm.decode_matmul(x, w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                timer.flush_buf.zero_()
                dmm.decode_matmul(x, w)
            torch.cuda.synchronize()
        print("profile", name, b, json.dumps({
            ev.key[:60]: ev.device_time_total / 5 / 1e3
            for ev in prof.key_averages()
            if ev.device_time_total > 0 and "fill" not in ev.key}),
            flush=True)
    for spec in cs.RING_CASES[:3]:
        try:
            c = cs._ring_case(torch, gen, timer, **spec)
        except RuntimeError as e:
            print("FAILED", spec["name"], e, flush=True)
            failed = True
            continue
        print(json.dumps({k: c[k] for k in (
            "case", "ms", "library_ms", "dkv_split", "grad_rel_err",
            "sdpa_ratio", "dq_dkv_sdpa_ratio")}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
