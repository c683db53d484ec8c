#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; each prints one JSON line with its seconds, and any
failure ends the run with a non-zero exit code and no result:

1. env           torch / CUDA versions and the card's name and power limit.
2. build         compiles ``paddle_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernels       each kernel against its plain PyTorch version on the card
                 at the Llama-3-8B serving shapes, with its time, the plain
                 version's time, the time of one PyTorch library call that
                 computes the same function where there is one, and the
                 least time the card could take (bound_ms).
4. tiny-parity   llama_tiny (float32, int4 weights) served on the card and,
                 with the same weights, on the CPU through the plain
                 versions: the greedy tokens must be equal, and one
                 prefill ministep's logits within 1e-3.
5. serve-int4    THE MAIN PATH: Llama-3-8B at full width and all 32 layers,
                 int4 weights from a seed, bf16 KV pool, block size 64,
                 served by the ragged engine (8 requests of 100..600 prompt
                 tokens, 32 new tokens each, 6 greedy and 2 at temperature
                 0.8). The launch counters are set to 0 just before and
                 read just after; a repeat run must give the same tokens;
                 one pure-decode ministep at W=8 must launch exactly 32
                 attention and 129 GEMV kernels.
6. serve-bf16-kv8  the same model with bf16 weights and an int8 KV pool
                 (4 requests): the int8 branch of the attention kernel on
                 the serving path.

Then a {"kernels": [...]} line, the card's name and power limit as
nvidia-smi reports them, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Bounds use the H100 SXM data sheet: 3.35 TB/s of device memory and
989 TFLOP/s dense bf16 on the tensor cores.
"""
import gc
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SHAPES_8B = {"wqkv": (4096, 6144), "wo": (4096, 4096),
             "wgu": (4096, 28672), "wd": (14336, 4096),
             "head": (4096, 128256)}


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _phase(name, fn):
    t0 = time.perf_counter()
    info = fn()
    _emit(dict(phase=name, seconds=round(time.perf_counter() - t0, 3),
               **info))
    return info


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def _bound(nbytes, flops):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the flops over the bf16 peak."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / BF16_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class _Timer:
    """Mean device time of fn over iters launches (CUDA events around
    each launch), with the 50 MB L2 flushed before each one: the serving
    path meets every weight and most pages cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, iters=10):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _device_breakdown(torch, fn, wall_ms):
    """Device time of fn by kernel family (torch.profiler), and the idle
    share of ``wall_ms``, the wall time of the same work measured
    without the profiler (which slows the host several fold). Reports
    what the profiler saw; an empty trace leaves the families empty
    rather than failing."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fams, other, kernels = {}, {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        name = ev.key
        kernels += ev.count
        if "decode_matmul_kernel" in name or "splitk_reduce_kernel" in name:
            fam = "decode_matmul"
        elif "ragged_attention_kernel" in name:
            fam = "ragged_paged_attention"
        elif any(s in name.lower() for s in ("gemm", "gemv", "nvjet")):
            fam = "library_gemm"
        else:
            fam = "other"
            other[name[:60]] = other.get(name[:60], 0.0) + us / 1e3
        fams[fam] = fams.get(fam, 0.0) + us / 1e3
    busy = sum(fams.values())
    return {"device_ms_by_family": fams, "device_ms": busy,
            "device_kernels": kernels, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if busy else None,
            "top_other": dict(sorted(other.items(),
                                     key=lambda kv: -kv[1])[:6])}


def _attention_case(torch, gen, quantized, n_decode=24, chunk=64,
                    n_pad=8, nh=32, kvh=8, d=128, bs=64, max_ctx=2048):
    """A ragged batch at the 8B attention shapes: decode rows with
    contexts up to max_ctx, one prefill chunk of `chunk` rows, padding
    rows."""
    dev = "cuda"
    mp = max_ctx // bs
    n_seqs = n_decode + 1
    nb = n_seqs * mp + 1
    tables = torch.randperm(nb, generator=gen, device=dev)[:n_seqs * mp] \
        .view(n_seqs, mp).to(torch.int32)
    dctx = torch.randint(1, max_ctx + 1, (n_decode,), generator=gen,
                         device=dev)
    off = int(torch.randint(0, max_ctx - chunk, (1,), generator=gen,
                            device=dev))
    row_seq = torch.cat([torch.arange(n_decode, device=dev),
                         torch.full((chunk,), n_decode, device=dev),
                         torch.zeros(n_pad, device=dev,
                                     dtype=torch.long)]).to(torch.int32)
    row_ctx = torch.cat([dctx, off + 1 + torch.arange(chunk, device=dev),
                         torch.zeros(n_pad, device=dev,
                                     dtype=torch.long)]).to(torch.int32)
    rows = row_seq.numel()
    q = torch.randn((rows, nh, d), generator=gen, device=dev) \
        .to(torch.bfloat16)

    def plane():
        if quantized:
            return (torch.randint(-127, 128, (nb, kvh, bs, d), generator=gen,
                                  device=dev).to(torch.int8),
                    (torch.rand((nb, kvh, bs), generator=gen, device=dev)
                     * 0.05 + 0.001))
        return torch.randn((nb, kvh, bs, d), generator=gen, device=dev) \
            .to(torch.bfloat16)

    k, v = plane(), plane()
    # bytes the function must move: q and out once, and for every
    # sequence the K/V pages its longest row sees (scales included)
    ctx_of = {}
    for s_, c_ in zip(row_seq.tolist(), row_ctx.tolist()):
        ctx_of[s_] = max(ctx_of.get(s_, 0), c_)
    pages = sum(-(-c_ // bs) for c_ in ctx_of.values() if c_ > 0)
    per_page = kvh * bs * d * (1 if quantized else 2) \
        + (kvh * bs * 4 if quantized else 0)
    nbytes = 2 * q.numel() * 2 + 2 * pages * per_page \
        + tables.numel() * 4 + rows * 8
    flops = 4 * nh * d * int(row_ctx.clamp(min=0).sum())
    return (q, k, v, tables, row_seq, row_ctx), nbytes, flops


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    import numpy as np
    from paddle_tpu_torch.inference import (PagedLlamaDecoder,
                                            SamplingParams, ServingEngine)
    from paddle_tpu_torch.models import llama_3_8b, llama_tiny
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import decode_matmul as dmm
    from paddle_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.qweight import QWeight

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    kernel_rows = []

    _phase("env", lambda: {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvidia_smi": smi, "device": device})

    def build():
        lib = _build.load_library()
        _require(lib is not None, "kernel library did not load")
        ptxas = {src: [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln][:8]
                 for src, out in _build.build_info.get("ptxas", {}).items()}
        return {"build_s": round(_build.build_info["seconds"], 3),
                "library": _build.build_info["library"], "ptxas": ptxas}

    _phase("build", build)
    timer = _Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # -- kernels against their plain versions --------------------------------
    def kernels():
        cases = []
        for quantized in (False, True):
            args, nbytes, flops = _attention_case(torch, gen, quantized)
            out = rpa.ragged_paged_attention_cuda(*args)
            ref = pa.ragged_paged_attention_reference(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = torch.allclose(out.float(), ref.float(), atol=1e-2,
                                rtol=1e-2)
            _require(ok, f"ragged_paged_attention (int8 pool="
                         f"{quantized}) differs from its plain version: "
                         f"max abs err {err}")
            pad = args[5] <= 0
            _require(bool((out[pad] == 0).all()),
                     "padding rows of ragged_paged_attention are not 0")
            case = {"kernel": "ragged_paged_attention",
                    "pool": "int8" if quantized else "bf16",
                    "rows": int(args[0].shape[0]), "max_abs_err": err,
                    "ms": timer(lambda: rpa.ragged_paged_attention_cuda(
                        *args)),
                    "plain_ms": timer(
                        lambda: pa.ragged_paged_attention_reference(*args),
                        iters=3),
                    "library_ms": None}
            case["bound_ms"], case["bound_by"] = _bound(nbytes, flops)
            cases.append(case)
            heads["int8" if quantized else "bf16"] = case

        def gemv_case(kind, name, b):
            K, N = SHAPES_8B[name]
            x = torch.randn((b, K), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            scale = torch.rand(N, generator=gen, device="cuda") * 0.02 \
                + 1e-3
            if kind == "dense":
                w = (torch.randn((K, N), generator=gen, device="cuda")
                     * 0.02).to(torch.bfloat16)
                wbytes = K * N * 2
            else:
                rows = K // 2 if kind == "int4_halves" else K
                q = torch.randint(-128, 128, (rows, N), generator=gen,
                                  device="cuda").to(torch.int8)
                w = QWeight(q, scale, kind)
                wbytes = rows * N + N * 4
            out = dmm.decode_matmul(x, w)
            ref = dmm.decode_matmul_reference(x, w)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max()
            rel = float(diff / ref.float().abs().max().clamp(min=1e-9))
            _require(rel < 2e-2, f"decode_matmul {kind} {name} b={b}: "
                                 f"relative max error {rel}")
            # the library yardstick: one torch.matmul on the weight
            # dequantized (and scaled) to bf16 ahead of time
            wl = w if kind == "dense" else \
                (dmm.dequantize(w) * scale).to(torch.bfloat16)
            case = {"kernel": "decode_matmul", "kind": kind, "shape": name,
                    "b": b, "K": K, "N": N,
                    "max_abs_err": float(diff), "rel_err": rel,
                    "ms": timer(lambda: dmm.decode_matmul(x, w), iters=20),
                    "plain_ms": timer(
                        lambda: dmm.decode_matmul_reference(x, w), iters=3),
                    "library_ms": timer(lambda: torch.matmul(x, wl),
                                        iters=20)}
            case["bound_ms"], case["bound_by"] = _bound(
                wbytes + x.numel() * 2 + b * N * 2, 2 * b * K * N)
            del wl
            cases.append(case)
            return case

        for name in SHAPES_8B:
            for b in (1, 8, 32):
                c = gemv_case("int4_halves", name, b)
                if name == "wgu" and b == 8:
                    heads["int4"] = c
        for kind in ("dense", "int8"):
            for b in (1, 8, 32):
                gemv_case(kind, "wgu", b)
        return {"cases": cases}

    heads = {}
    _phase("kernels", kernels)
    torch.cuda.empty_cache()

    def counts():
        return {"ragged_paged_attention": rpa.launches,
                "decode_matmul": dmm.launches}

    def reset_counts():
        rpa.launches = 0
        dmm.launches = 0

    # -- tiny model: card against the CPU's plain path -----------------------
    def tiny_parity():
        cfg = llama_tiny()
        cpu = PagedLlamaDecoder.from_config(cfg, seed=3, weight_dtype="int4",
                                            num_blocks=64, block_size=8,
                                            device="cpu")

        def to_cuda(w):
            if isinstance(w, QWeight):
                return QWeight(w.q.cuda(), w.scale.cuda(), w.kind)
            return w.cuda()

        weights = {"embed": cpu.weights["embed"].cuda(),
                   "norm": cpu.weights["norm"].cuda(),
                   "head": to_cuda(cpu.weights["head"]),
                   "layers": [{k: to_cuda(v) for k, v in lw.items()}
                              for lw in cpu.weights["layers"]]}
        gpu = PagedLlamaDecoder(cfg, weights, weight_dtype="int4",
                                num_blocks=64, block_size=8, device="cuda")
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 12, 30)]
        outs = []
        reset_counts()
        for dec in (cpu, gpu):
            eng = ServingEngine(dec, max_batch_size=3, chunk_size=4,
                                prefill_chunk=8)
            rids = [eng.add_request(p, SamplingParams(max_new_tokens=8))
                    for p in prompts]
            eng.run_to_completion()
            outs.append([eng.result(r).tolist() for r in rids])
            eng.close()
        launched = counts()
        _require(all(v > 0 for v in launched.values()),
                 f"tiny-parity did not launch every kernel: {launched}")
        # one ministep on identical rows: an 8-row prefill chunk of a
        # fresh sequence, whose visible K/V this ministep writes itself
        rows = 8
        ids_np = rng.randint(0, cfg.vocab_size, rows)
        logits = []
        for dec in (cpu, gpu):
            dev = dec.device
            dec.cache.allocate(100, rows)
            slots = [dec.cache.extend(100) for _ in range(rows)]
            tables = np.stack([dec.cache.block_table(100, dec.max_pages)])
            pos = torch.arange(rows, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                lg, _, _ = dec._ragged_logits(
                    dec.weights, dec.cache.k, dec.cache.v,
                    torch.as_tensor(ids_np, dtype=torch.int32, device=dev),
                    pos, torch.as_tensor(slots, dtype=torch.int32,
                                         device=dev),
                    torch.zeros(rows, dtype=torch.int32, device=dev),
                    pos + 1, torch.as_tensor(tables, device=dev))
            logits.append(lg.float().cpu())
            dec.cache.free(100)
        err = float((logits[0] - logits[1]).abs().max())
        _require(err < 1e-3, f"tiny-parity ministep logits differ by {err}")
        _require(outs[0] == outs[1],
                 f"tiny-parity greedy tokens differ: cpu {outs[0]} vs "
                 f"cuda {outs[1]}")
        return {"tokens_equal": True, "ministep_logits_max_abs_err": err,
                "launches": launched}

    _phase("tiny-parity", tiny_parity)

    # -- the main path: 8B int4 serving --------------------------------------
    cfg = llama_3_8b(dtype="bfloat16")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, int(n))
               for n in rng.randint(100, 601, 8)]
    temps = [0.0] * 6 + [0.8] * 2

    def serve(dec, n_req, seed=0):
        eng = ServingEngine(dec, max_batch_size=8, prefill_chunk=256,
                            chunk_size=8, seed=seed)
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=32,
                                                  temperature=t))
                for p, t in zip(prompts[:n_req], temps[-n_req:])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        outs = [eng.result(r) for r in rids]
        eng.close()
        _require(st["finished"] == n_req, f"only {st['finished']} of "
                                          f"{n_req} requests finished")
        for o in outs:
            _require(len(o) == 32 and o.min() >= 0
                     and o.max() < cfg.vocab_size,
                     f"bad output tokens {o}")
        dec.cache.debug_check()
        return outs, wall, st

    def decode_ministep(dec, w=8, ctx=512):
        """One pure-decode ministep of w rows at context ctx on real
        pages: (launch counts of one ministep, mean wall ms of a
        ministep including the greedy sample, its device time by kernel
        family per ministep)."""
        cache = dec.cache
        ids = list(range(1000, 1000 + w))
        for sid in ids:
            cache.allocate(sid, ctx + 1)
            for _ in range(ctx):
                cache.extend(sid)
        slots = [cache.extend(sid) for sid in ids]
        tables = np.full((w + 1, dec.max_pages), cache._tables[-1][0],
                         np.int32)
        for i, sid in enumerate(ids):
            tables[i] = cache.block_table(sid, dec.max_pages)
        dev = dec.device
        args = (torch.randint(0, cfg.vocab_size, (w,), generator=gen,
                              device=dev, dtype=torch.int32),
                torch.full((w,), ctx, dtype=torch.int32, device=dev),
                torch.as_tensor(slots, dtype=torch.int32, device=dev),
                torch.arange(w, dtype=torch.int32, device=dev),
                torch.full((w,), ctx + 1, dtype=torch.int32, device=dev),
                torch.as_tensor(tables, device=dev))

        def ministep():
            lg, _, _ = dec._ragged_logits(dec.weights, cache.k, cache.v,
                                          *args)
            return lg.argmax(dim=-1)

        with torch.inference_mode():
            reset_counts()
            ministep()
            torch.cuda.synchronize()
            one = counts()
            t0 = time.perf_counter()
            n = 10
            for _ in range(n):
                ministep()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            prof = _device_breakdown(
                torch, lambda: [ministep() for _ in range(n)], wall_ms * n)
        for k in ("device_ms", "device_kernels", "wall_ms"):
            prof[k] /= n
        prof["device_ms_by_family"] = {
            k: v / n for k, v in prof["device_ms_by_family"].items()}
        prof["top_other"] = {k: v / n for k, v in prof["top_other"].items()}
        for sid in ids:
            cache.free(sid)
        return one, wall_ms, prof

    main_launches = {}

    def serve_int4():
        t0 = time.perf_counter()
        dec = PagedLlamaDecoder.from_config(cfg, seed=0, weight_dtype="int4",
                                            block_size=64, num_blocks=160,
                                            device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        reset_counts()
        outs1, wall1, _ = serve(dec, 8)
        main_launches.update(counts())
        _require(all(v > 0 for v in main_launches.values()),
                 f"a kernel of the main path never launched: "
                 f"{main_launches}")
        outs2, wall2, st2 = serve(dec, 8)
        for i, (a, b) in enumerate(zip(outs1, outs2)):
            _require(np.array_equal(a, b),
                     f"request {i} (temperature {temps[i]}) differs "
                     f"between two runs with the same seed")
        serve_profile = _device_breakdown(torch, lambda: serve(dec, 8),
                                          wall2 * 1e3)
        one, wall_ms, step_profile = decode_ministep(dec)
        _require(one == {"ragged_paged_attention": 32, "decode_matmul": 129},
                 f"one pure-decode ministep at W=8 launched {one}, "
                 f"expected 32 attention and 129 GEMV kernels")
        weight_bytes = sum(
            (w.q.numel() + w.scale.numel() * 4) if isinstance(w, QWeight)
            else w.numel() * w.element_size()
            for lw in dec.weights["layers"] for w in lw.values()) \
            + dec.weights["head"].q.numel()
        # throughput and latencies of the second (warm) run
        info = {"model": "llama_3_8b int4 (halves), bf16 KV pool, 32 layers",
                "load_s": round(load_s, 3),
                "launches": dict(main_launches),
                "wall_s": [wall1, wall2],
                "tok_per_s": st2["generated_tokens"] / wall2,
                "generated_tokens": st2["generated_tokens"],
                "device_dispatches": st2["device_dispatches"],
                "ttft_p50_s": st2["ttft_p50_s"],
                "itl_p50_s": st2["itl_p50_s"],
                "itl_p99_s": st2["itl_p99_s"],
                "decode_ministep_launches": one,
                "decode_ministep_W8_ctx512_wall_ms": wall_ms,
                "decode_ministep_profile": step_profile,
                "serve_profile": serve_profile,
                "decode_weight_floor_ms":
                    1e3 * weight_bytes / HBM_BYTES_PER_S,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "sample_tokens": outs1[0][:8].tolist()}
        del dec
        return info

    _phase("serve-int4", serve_int4)
    gc.collect()
    torch.cuda.empty_cache()
    kv8_launches = {}

    def serve_bf16_kv8():
        dec = PagedLlamaDecoder.from_config(cfg, seed=0, weight_dtype=None,
                                            kv_quant="int8", block_size=64,
                                            num_blocks=96, device="cuda")
        reset_counts()
        outs, wall, st = serve(dec, 4)
        kv8_launches.update(counts())
        _require(kv8_launches["ragged_paged_attention"] > 0,
                 "the int8-pool attention kernel never launched")
        _require(kv8_launches["decode_matmul"] == 0,
                 "bf16 weights must not reach the int4 GEMV")
        del dec
        return {"model": "llama_3_8b bf16 weights, int8 KV pool, 32 layers",
                "launches": dict(kv8_launches),
                "tok_per_s": st["generated_tokens"] / wall, "wall_s": wall,
                "sample_tokens": outs[0][:8].tolist()}

    _phase("serve-bf16-kv8", serve_bf16_kv8)

    tpu = "paddle_tpu/ops/pallas/"
    for key, name, launches, src, rep in (
            ("bf16", "ragged_paged_attention",
             main_launches["ragged_paged_attention"],
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             tpu + "ragged_paged_attention.py:201"),
            ("int8", "ragged_paged_attention[int8 pool]",
             kv8_launches["ragged_paged_attention"],
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             tpu + "ragged_paged_attention.py:201"),
            ("int4", "decode_matmul[int4]", main_launches["decode_matmul"],
             "paddle_tpu_torch/csrc/decode_matmul.cu",
             tpu + "decode_matmul.py:135")):
        c = heads[key]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    _emit({"kernels": kernel_rows})
    print(smi, flush=True)
    _emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
