#!/usr/bin/env python3
"""Quick check of the port's flash-attention kernels on one CUDA card.

Run from the root of the repository:  python3 tools/flash_probe.py [DIR]

Builds the kernels (printing ptxas's registers and spills of each flash
kernel, and writing the whole ptxas report of flash_attention_wg.cu and
the library's SASS into DIR when one is given), refuses to go on unless
each Hopper kernel has 168 registers a thread (its setmaxnreg split
would wait forever) and HGMMA and UTMALDG in its SASS, runs the forward,
dq and dk/dv kernels on a few small cases (bf16 and float32, GQA, causal
with sq != sk, packed segments, head_dim 64/72/128/256) against
``flash_attention_plain`` in float32 with autograd, printing one JSON
line per case (max abs error of out and lse, relative max error of
out and dq/dk/dv, whether two forward and two backward runs are
bit-identical; at head_dim 72 the forward's device ms beside SDPA's
forward where SDPA computes the same function), then times each kernel
and the library's scaled_dot_product_attention at the llama_mid shape
(b 4, s 2048, h 16, kv 8, d 128, bf16, causal; forward) and at
DiT-XL/2's (b 32, s 256, h 16, kv 16, d 72, bf16, not causal; forward
and backward; the forward and SDPA's forward alternated, the L2 flushed
before each launch).
It is the short first call after a kernel change; chip_smoke.py holds
the full checks.
"""
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    print("build_s", _build.build_info["seconds"])
    regs = {}
    for src in ("flash_attention.cu", "flash_attention_wg.cu"):
        report = _build.build_info["ptxas"].get(src, "")
        for name, lines in chip_smoke._flash_ptxas(report).items():
            print(name, lines, flush=True)
            used = [int(m.group(1)) for ln in lines
                    for m in [re.search(r"Used (\d+) registers", ln)] if m]
            if name.startswith("flash_wg") and used:
                regs[name] = used[0]
                if any(int(m.group(1)) for ln in lines
                       for m in [re.search(r"(\d+) bytes spill stores", ln)]
                       if m):
                    print("flash_probe: spills in", name, flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "--dump-sass",
         str(_build.BUILD_DIR / _build.build_info["library"])],
        capture_output=True, text=True).stdout
    found = chip_smoke._count_sass(sass, chip_smoke._flash_wg_name,
                                   ("HGMMA", "UTMALDG"))
    print("flash_wg_sass", json.dumps(found), flush=True)
    if len(sys.argv) > 1:
        # the whole ptxas report and the library's SASS, for reading off
        # the card
        out_dir = Path(sys.argv[1])
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "ptxas_wg.txt").write_text(
            _build.build_info["ptxas"].get("flash_attention_wg.cu", ""))
        (out_dir / "sass.txt").write_text(sass)
    # the Hopper kernels move registers between warpgroups with
    # setmaxnreg, which waits forever unless the launch holds 168 a thread
    want = set(chip_smoke._flash_wg_kernels(fa))
    bad = {k: r for k, r in regs.items() if r != 168}
    if bad or set(regs) != want or set(found) != want or not all(
            min(c.values()) > 0 for c in found.values()):
        print("flash_probe: unexpected register counts or SASS", regs,
              file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = chip_smoke._Timer(torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def case(b, sq, sk, h, hk, d, dt, causal, seg=False):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)
        qs = ks = None
        if seg:
            qs = (torch.arange(sq, device="cuda") // max(1, sq // 4)) \
                .to(torch.int32)[None].repeat(b, 1)
            qs[:, -sq // 8:] = -1
            ks = qs.clone()
            ks[:, -sq // 8:] = -2
        sc = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, causal, sc, qs, ks)
        out2, lse2 = fa.flash_fwd_cuda(q, k, v, causal, sc, qs, ks)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ro, rl = flash_attention_plain(*leaves, causal, sc, qs, ks)
        do = rnd(*ro.shape)
        (ro * do.float()).sum().backward()
        runs = [fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, sc, qs, ks)
                for _ in range(2)]
        torch.cuda.synchronize()

        def rel(a, r):
            return float((a.float() - r).abs().max()
                         / r.abs().max().clamp(min=1e-9))
        line = dict(
            shape=(b, sq, sk, h, hk, d, str(dt), causal, seg),
            out=float((out.float() - ro.detach()).abs().max()),
            out_rel=rel(out, ro.detach()),
            lse=float((lse - rl.detach()).abs().max()),
            dq=rel(runs[0][0], leaves[0].grad),
            dk=rel(runs[0][1], leaves[1].grad),
            dv=rel(runs[0][2], leaves[2].grad),
            fwd_identical=torch.equal(out, out2) and torch.equal(lse, lse2),
            identical=all(torch.equal(a, b_)
                          for a, b_ in zip(runs[0], runs[1])),
            nan=bool(torch.isnan(out).any()))
        if d == 72 and dt == bf16:
            line["fwd_ms"] = timer(
                lambda: fa.flash_fwd_cuda(q, k, v, causal, sc, qs, ks))
            if sq == sk and not seg:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                line["sdpa_fwd_ms"] = timer(lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
        print(json.dumps(line), flush=True)

    bf16, f32 = torch.bfloat16, torch.float32
    case(2, 256, 256, 4, 2, 128, bf16, True)
    case(2, 300, 1000, 8, 2, 64, bf16, True)
    case(1, 1000, 300, 4, 4, 64, bf16, True)
    case(1, 200, 200, 4, 1, 128, bf16, False, seg=True)
    case(1, 300, 1000, 4, 1, 64, f32, True)
    case(1, 200, 200, 2, 2, 256, bf16, False)
    case(1, 512, 512, 4, 2, 128, bf16, True, seg=True)
    case(1, 1000, 300, 4, 4, 64, f32, True)
    # head_dim 72: the Hopper kernels (tiles padded to 128 columns)
    case(2, 256, 256, 4, 4, 72, bf16, False)
    case(2, 300, 1000, 8, 2, 72, bf16, True)
    case(1, 512, 512, 4, 2, 72, bf16, True, seg=True)
    case(1, 200, 700, 4, 4, 72, bf16, False)

    b, s, h, hk, d = 4, 2048, 16, 8, 128
    q = torch.randn(b, s, h, d, device="cuda", dtype=bf16)
    k = torch.randn(b, s, hk, d, device="cuda", dtype=bf16)
    v = torch.randn(b, s, hk, d, device="cuda", dtype=bf16)
    sc = d ** -0.5

    def timed(fn, n=20):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    out, lse = fa.flash_fwd_cuda(q, k, v, True, sc)
    do = torch.randn_like(out)
    delta = fa.flash_bwd_delta(out, do)
    print("fwd_ms", timed(lambda: fa.flash_fwd_cuda(q, k, v, True, sc)))
    print("dq_ms", timed(lambda: fa.flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, True, sc)))
    print("dkv_ms", timed(lambda: fa.flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, True, sc)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    print("sdpa_fwd_ms", timed(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))

    # DiT-XL/2's attention: b 32 x 256 patches, 16 heads of 72, not causal
    b, s, h, d = 32, 256, 16, 72
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", dtype=bf16)
                   for _ in range(4))
    sc = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, False, sc)
    again = fa.flash_fwd_cuda(q, k, v, False, sc)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), False,
                                sc)[0]
    fwd_rel = float((out.float() - ref).abs().max() / ref.abs().max())
    del ref
    delta = fa.flash_bwd_delta(out, do)
    dq_ms = timed(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                               False, sc))
    dkv_ms = timed(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 False, sc))
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    l_out = sdpa(*leaves)
    bwd_ms = timed(lambda: torch.autograd.grad(
        l_out, leaves, do.transpose(1, 2), retain_graph=True))
    # the forward and SDPA's forward alternated, 4 rounds of 20 launches
    # each, the L2 flushed before each launch
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd_ms, sdpa_ms = [], []
    for _ in range(4):
        fwd_ms.append(timer(lambda: fa.flash_fwd_cuda(q, k, v, False, sc),
                            iters=20))
        sdpa_ms.append(timer(lambda: sdpa(qt, kt, vt), iters=20))
    print("dit_xl2", json.dumps(dict(
        fwd_ms=fwd_ms, sdpa_fwd_ms=sdpa_ms,
        fwd_over_sdpa=statistics.median(fwd_ms)
        / statistics.median(sdpa_ms),
        fwd_rel_err=fwd_rel,
        fwd_identical=torch.equal(out, again[0])
        and torch.equal(lse, again[1]),
        dq_ms=dq_ms, dkv_ms=dkv_ms,
        sdpa_bwd_ms=bwd_ms, bwd_over_sdpa=(dq_ms + dkv_ms) / bwd_ms)),
        flush=True)
    if fwd_rel > 1e-2 or not torch.equal(out, again[0]):
        print("flash_probe: the d-72 forward is off its plain version or "
              "not bit-identical", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
