#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; each prints one JSON line with its seconds, and any
failure ends the run with a non-zero exit code and no result:

1. env           torch / CUDA versions and the card's name and power limit.
2. build         compiles ``paddle_tpu_torch/csrc/*.cu`` for sm_90a; the
                 SASS of the six Hopper flash kernels (forward, dq,
                 dk/dv at head_dim 64 and 128) must hold HGMMA (wgmma)
                 and UTMALDG (TMA load) instructions, and each must have
                 been built with 168 registers a thread (its setmaxnreg
                 split needs them; a launch with fewer raises); the nine
                 bfloat16 decode_matmul instantiations must hold HMMA
                 (mma.sync); the six tensor-core paged-attention kernels
                 (ragged at head_dim 64 / 128 with bf16 and int8 pools,
                 decode at 64 / 128) must hold HMMA and UTMALDG, the two
                 int8 ones UBLKCP (their scale rows). Prints ptxas's
                 registers and spills of every flash, GEMV and
                 paged-attention instantiation and the paged kernels'
                 dynamic shared memory.
3. kernels       each kernel against its plain PyTorch version on the card
                 at the shapes its main path gives it (Llama-3-8B serving:
                 ragged attention on the smoke batch with a bf16 and an
                 int8 pool, a W 8 decode ministep at ctx 512, a 128-row
                 prefill rung, and d 64 with pages smaller than a stage;
                 dense decode at b 8 and b 4 and at ctx 1..2100 with a
                 ctx-0 row, float32 at d 64, d 256, the int8-pool route
                 and bf16 at d 64 / bs 16; every attention case within 1e-2
                 (1e-4 float32), no NaN, ctx-0 rows exact zeros, two runs
                 bit-identical, with its share of the bound, its plan and,
                 where its rows see one ctx, SDPA's time over the same
                 K/V rows gathered beforehand (not paged); the GEMV at b 1/4/8/32 (int4 on the
                 five projections, int8 and dense on wgu at b 1/8/32,
                 one float32 int4 case on the CUDA-core kernel), each
                 with its share of the bound and its split plan, and
                 the int4/int8 cases slower than torch.matmul listed;
                 flash forward
                 at the dense prefill's b x s of 1 x 256, 4 x 128, 4 x 256
                 and 1 x 512; llama_mid training attention, plus a 4096
                 sequence, packed documents and a causal sq < sk case with
                 ragged edges; the ring blocks flash_attention_with_lse and
                 flash_attention_bwd_block at train-mid8k's shard shapes,
                 the backward against a lse merged from two blocks, its
                 dq and dk/dv kernels also timed apart, with the pieces
                 of the dk/dv work list),
                 with its time, the plain version's time, the time of one
                 PyTorch library call that computes the same function where
                 there is one, and the least time the card could take
                 (bound_ms); for the flash cases also the achieved TFLOP/s,
                 the share of the bound and the ratio to SDPA's time in the
                 same run. Flash backward runs must be bit-identical.
4. tiny-parity   llama_tiny (float32, int4 weights) served on the card and,
                 with the same weights, on the CPU through the plain
                 versions: the greedy tokens must be equal, and one
                 prefill ministep's logits within 1e-3.
5. tiny-dense-parity  llama_tiny(hidden_size=256) (head_dim 64, int4)
                 through the dense engine (mid chunks, offset finals) and
                 generate() on the card and the CPU: equal greedy tokens,
                 one prefill's logits within 1e-3, and the card ran the
                 paged-decode, flash forward and GEMV kernels.
6. serve-int4    THE MAIN PATH: Llama-3-8B at full width and all 32 layers,
                 int4 weights from a seed, bf16 KV pool, block size 64,
                 served by the ragged engine (8 requests of 100..600 prompt
                 tokens, 32 new tokens each, 6 greedy and 2 at temperature
                 0.8). The launch counters are set to 0 just before and
                 read just after; a repeat run must give the same tokens;
                 one pure-decode ministep at W=8 must launch exactly 32
                 attention and 129 GEMV kernels; the decode_matmul and
                 attention families' device ms per serving run and per
                 ministep.
7. serve-dense-int4  THE DENSE PATH on the same decoder:
                 ServingEngine(ragged=False, max_batch_size=8, chunk_size=8,
                 prefill_chunk=256), 8 requests of 100..512 prompt tokens,
                 32 new each (6 greedy, 2 at 0.8). Counters set to 0 just
                 before and read just after, and must equal what the run's
                 dispatches call for: 32 paged-decode and 129 GEMV launches
                 per decode step, 32 flash forward launches per
                 _prefill_impl dispatch, the GEMV's share of each prefill
                 dispatch, no ragged launch. A repeat run gives the same
                 tokens; one decode step at mb 8 launches exactly 32
                 paged-decode and 129 GEMV kernels; its wall and device
                 time beside the ragged ministep of phase 6; generate() at
                 b 4, prompt 256, 32 new tokens; then both engines on the
                 same 8 requests, alternately, 4 runs each, and their
                 decode steps alternately, 3 each (median, min, max);
                 the decode_matmul and attention families' device ms per
                 run and step.
8. serve-bf16-kv8  the same model with bf16 weights and an int8 KV pool
                 (4 requests): the int8 branch of the attention kernel on
                 the serving path; one W 8 ministep launches exactly 32
                 attention kernels; the attention family's device ms per
                 run and per ministep.
9. tiny-train-parity  llama_tiny(hidden_size=256) in float32 (head_dim 64)
                 with the same weights on the card and the CPU: 3 TrainSteps
                 of AdamW(1e-3) give losses within 1e-4 relative, and the
                 card ran all three flash kernels.
10. tiny-ring-parity  llama_tiny(hidden_size=256, sep_degree=4) in
                 float32 (head_dim 64) at b 2 x s 256 under a sep-4 fleet
                 mesh, the same weights on the card (["cuda:0"] * 4) and on
                 the CPU (["cpu"] * 4): 3 TrainSteps of AdamW(1e-3) give
                 losses within 1e-4 relative, the card's equal the same
                 model's at sep_degree=1 within 1e-4, and the flash counters
                 read exactly what the ring calls for (2 layers x 4 ranks
                 x 6 blocks per step of each kernel).
11. train-mid    THE TRAINING PATH: llama_mid (0.65B) at full width and all
                 11 layers, bf16 compute, seed 0, batch 4 x seq 2048 (ids as
                 bench.py makes them), AdamW(1e-4, weight_decay=0.01): 2 warm
                 and 10 timed TrainSteps. The flash counters are set to 0
                 just before and read just after: exactly 11 forward, 11 dq
                 and 11 dk/dv launches per step; every loss finite and the
                 last below the first. Step ms, tokens/s, MFU by bench.py's
                 formula against 989 TFLOP/s, peak memory, device time by
                 kernel family and the idle share.
12. train-mid8k  THE LONG-CONTEXT PATH: llama_mid(dtype="bfloat16",
                 chunked_ce_tokens=1024, max_position_embeddings=8192,
                 sep_degree=4), all 11 layers, b 1 x s 8192 (ids as bench.py
                 makes them), AdamW(1e-4, weight_decay=0.01), under a sep-4
                 fleet mesh on ["cuda:0"] * 4: every attention is zigzag ring
                 attention whose blocks run the flash kernels. 2 warm and 5
                 timed steps; the flash counters, set to 0 just before and
                 read just after, must read exactly 264 forward, 264 dq and
                 264 dk/dv launches per step (11 layers x 4 ranks x 6
                 blocks); every loss finite, the last below the first. Then
                 the same config at sep_degree=1 (11 of each per step) and
                 sep 4 alternated on the same ids, 3 runs of 2 steps each
                 (median, min, max step ms); the first-step losses of sep 1
                 and sep 4 within 1e-2 relative. Step ms, tokens/s, MFU at
                 seq 8192, peak memory, device time by kernel family (the
                 flash family's ms apart) and the idle share of both.

Then a {"kernels": [...]} line, the card's name and power limit as
nvidia-smi reports them, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Bounds use the H100 SXM data sheet: 3.35 TB/s of device memory and
989 TFLOP/s dense bf16 on the tensor cores.
Serving and training leave each other's counters alone: each path resets
and reads only its own kernels' counters.
"""
import gc
import importlib
import json
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
SHAPES_8B = {"wqkv": (4096, 6144), "wo": (4096, 4096),
             "wgu": (4096, 28672), "wd": (14336, 4096),
             "head": (4096, 128256)}
# flash attention cases (all causal, bf16 unless named): the llama_mid
# training shape first; `docs` packed documents plus a padded tail. bf16
# at d 64/128 runs the Hopper (wgmma, TMA) kernels, float32 and d 256 the
# CUDA-core ones. The dense_* cases are the 8B dense prefill's own
# calls: a mid chunk (b 1 x 256), grouped finals (4 rows of a 128 or 256
# bucket; generate()'s b 4 x 256) and a lone final of the 512 bucket. Its
# pad tokens sit at the end of each row and the call is plain causal, so
# the kernel sees them as ordinary positions that no real token attends.
FLASH_CASES = [
    dict(name="llama_mid", b=4, sq=2048, sk=2048, h=16, hk=8, d=128),
    dict(name="dense_b1_s256", b=1, sq=256, sk=256, h=32, hk=8, d=128),
    dict(name="dense_b4_s128", b=4, sq=128, sk=128, h=32, hk=8, d=128),
    dict(name="dense_b4_s256", b=4, sq=256, sk=256, h=32, hk=8, d=128),
    dict(name="dense_b1_s512", b=1, sq=512, sk=512, h=32, hk=8, d=128),
    dict(name="seq4096", b=2, sq=4096, sk=4096, h=16, hk=8, d=128),
    dict(name="packed", b=1, sq=2048, sk=2048, h=16, hk=8, d=128, docs=4),
    dict(name="sq300_sk1000", b=2, sq=300, sk=1000, h=8, hk=2, d=64),
    dict(name="f32_d128", b=1, sq=512, sk=512, h=4, hk=2, d=128, docs=2,
         dtype="float32"),
    dict(name="d256", b=1, sq=300, sk=300, h=4, hk=1, d=256),
]


# ring attention blocks at train-mid8k's shard shapes (llama_mid, sep 4,
# s 8192: local s 2048, zigzag halves of 1024; h 16, kv 8, d 128, bf16):
# the diagonal step's causal block, an "earlier" block (the full local q
# against a visiting early kv half) and a "later" block (the late q half
# against a whole visiting chunk); and tiny-ring-parity's earlier block in
# float32 at d 64
RING_CASES = [
    dict(name="diagonal", sq=1024, sk=1024, causal=True),
    dict(name="earlier", sq=2048, sk=1024, causal=False),
    dict(name="later", sq=1024, sk=2048, causal=False),
    dict(name="f32_d64_earlier", b=2, sq=64, sk=32, h=4, hk=2, d=64,
         causal=False, dtype="float32"),
]


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


def _bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the flops over the peak rate of their
    type (bf16 unless given)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class _Timer:
    """Mean device time of fn over iters launches (CUDA events around
    each launch), with the 50 MB L2 flushed before each one: the serving
    path meets every weight and most pages cold. The card first sleeps
    long enough for the host to queue every launch, so the events time
    the device alone, not a host that falls behind it (a wrapper's
    Python can take longer to queue a call than the flush runs)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, iters=10):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        # ~2e7 cycles (over 10 ms) per 10 launches queued behind it
        torch.cuda._sleep(2_000_000 * iters)
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
        if re.search(r"tc::tc_kernel|cc::cc_kernel|splitk_reduce_kernel",
                     name):
            fam = "decode_matmul"
        elif re.search(r"ragged_attention_(cc_)?kernel", name):
            fam = "ragged_paged_attention"
        elif re.search(r"paged_decode_(cc_)?kernel", name):
            fam = "paged_attention_decode"
        elif re.search(r"flash_fwd_kernel|flash_wg::.*fwd_kernel", name):
            fam = "flash_fwd"
        elif re.search(r"flash_bwd_|flash_wg::.*(d(q|kv)_kernel|"
                       r"dkv_piece_sum)", name):
            fam = "flash_bwd"
        elif any(s in name.lower()
                 for s in ("gemm", "gemv", "nvjet", "cutlass")):
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


def _flash_ptxas(report):
    """ptxas's registers and spills for each flash kernel instantiation."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                      r"I(13__nv_bfloat16|f)Li(\d+)E", ln)
        wg = re.search(r"flash_wg.*?(fwd|dq|dkv)_kernelILi(\d+)E", ln)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            name = f"{m.group(1)}<{dt},{m.group(3)}>"
        elif wg:
            name = f"flash_wg::{wg.group(1)}_kernel<bf16,{wg.group(2)}>"
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


_GEMV_KINDS = {"0": "dense", "1": "int8", "2": "int4_halves"}


def _gemv_name(mangled):
    """decode_matmul's instantiation behind a mangled name, or None:
    tc_kernel<kind, n-tiles> (bfloat16, tensor cores) or
    cc_kernel<kind, rows> (float32, CUDA cores)."""
    m = re.search(r"(tc|cc)_kernelILi(\d)ELi(\d+)E", mangled)
    if not m:
        return None
    return f"{m.group(1)}_kernel<{_GEMV_KINDS[m.group(2)]},{m.group(3)}>"


def _gemv_ptxas(report):
    """ptxas's registers and spills for each decode_matmul instantiation
    (the report of decode_matmul.cu)."""
    out, name = {}, None
    for ln in report.splitlines():
        if "entry function" in ln or "Function properties" in ln:
            name = _gemv_name(ln)
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def _sass(lib_path):
    """The built library's SASS (cuobjdump --dump-sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    _require(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    return res.stdout


def _count_sass(sass, name_of, ops):
    """{kernel: {op: count}} over the functions of the SASS text whose
    mangled name name_of maps to a kernel name (None skips)."""
    found, name = {}, None
    for ln in sass.splitlines():
        fn = re.search(r"Function : (\S+)", ln)
        if fn:
            name = name_of(fn.group(1))
            if name:
                found.setdefault(name, {op: 0 for op in ops})
        elif name:
            for op in ops:
                if re.search(rf"\b{op}\b", ln):
                    found[name][op] += 1
    return found


def _flash_wg_name(mangled):
    wg = re.search(r"flash_wg.*?(fwd|dq|dkv)_kernelILi(\d+)E", mangled)
    return (f"flash_wg::{wg.group(1)}_kernel<bf16,{wg.group(2)}>"
            if wg else None)


def _flash_sass(sass):
    """Count HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    Hopper flash kernel of the built library; fails unless all six (fwd,
    dq, dk/dv at head_dim 64 and 128) have both."""
    found = _count_sass(sass, _flash_wg_name, ("HGMMA", "UTMALDG"))
    _require(len(found) == 6 and all(min(c.values()) > 0
                                     for c in found.values()),
             f"flash_wg kernels without HGMMA or UTMALDG in SASS: {found}")
    return found


def _gemv_sass(sass):
    """HMMA (mma.sync) instructions in each bfloat16 decode_matmul
    instantiation; fails unless all nine (three weight kinds at 1, 2 and
    4 n-tiles) have some."""
    found = _count_sass(
        sass, lambda m: (_gemv_name(m) if "tc_kernel" in m else None),
        ("HMMA",))
    _require(len(found) == 9 and all(c["HMMA"] > 0 for c in found.values()),
             f"bf16 decode_matmul kernels without HMMA in SASS: {found}")
    return found


def _paged_name(mangled):
    """The paged-attention kernel behind a mangled name, or None: the
    tensor-core kernels ragged_attention_kernel<d, pool> and
    paged_decode_kernel<d, bf16>, and the CUDA-core *_cc_kernel forms."""
    m = re.search(r"(ragged_attention|paged_decode)_kernelILi(\d+)E"
                  r"(?:Lb([01])E)?E", mangled)
    if m:
        return (f"{m.group(1)}_kernel<{m.group(2)},"
                f"{'int8' if m.group(3) == '1' else 'bf16'}>")
    m = re.search(r"(ragged_attention|paged_decode)_cc_kernelI(\w+?)EEv",
                  mangled)
    return f"{m.group(1)}_cc_kernel<{m.group(2)}>" if m else None


def _paged_ptxas(report):
    """ptxas's registers, spills and static shared memory for each
    paged-attention kernel (the reports of ragged_paged_attention.cu and
    paged_attention_decode.cu)."""
    out, name = {}, None
    for ln in report.splitlines():
        if "entry function" in ln or "Function properties" in ln:
            name = _paged_name(ln)
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def _paged_sass(sass):
    """HMMA (mma.sync), UTMALDG (TMA tensor load) and UBLKCP (1-D bulk
    copy) instructions in each tensor-core paged-attention kernel; fails
    unless all six (ragged at head_dim 64 / 128 with bf16 and int8 pools,
    decode at 64 / 128) have HMMA and UTMALDG and the two int8 ones
    UBLKCP (their scale rows)."""
    found = _count_sass(
        sass, lambda m: (_paged_name(m) if re.search(
            r"(ragged_attention|paged_decode)_kernelI", m) else None),
        ("HMMA", "UTMALDG", "UBLKCP"))
    _require(len(found) == 6
             and all(c["HMMA"] > 0 and c["UTMALDG"] > 0
                     and (c["UBLKCP"] > 0 or not k.endswith("int8>"))
                     for k, c in found.items()),
             f"paged-attention kernels without HMMA, UTMALDG or (int8) "
             f"UBLKCP in SASS: {found}")
    return found


def _flash_inputs(torch, gen, b, sq, sk, h, hk, d, docs=0,
                  dtype="bfloat16"):
    """q, k, v, dout of dtype and, with docs, int32 segment ids: `docs`
    documents of random lengths and a padded tail of sq // 16 tokens (q
    ids -1, kv ids -2, so the tail sees nothing). Also the visible
    (query, key) pairs per head under the causal mask, from these ids."""
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev) \
            .to(getattr(torch, dtype))

    q, k, v, dout = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d), \
        rnd(b, sq, h, d)
    qs = ks = None
    vis = (torch.arange(sq, device=dev)[:, None] + (sk - sq)
           >= torch.arange(sk, device=dev)[None, :])[None]
    if docs:
        tail = sq // 16
        cuts = torch.randperm(sq - tail - 1, generator=gen,
                              device=dev)[:docs - 1] + 1
        seg = (torch.arange(sq, device=dev)[:, None]
               >= cuts[None, :]).sum(1).to(torch.int32)
        qs, ks = seg.clone(), seg.clone()
        qs[sq - tail:], ks[sq - tail:] = -1, -2
        qs, ks = qs[None].repeat(b, 1), ks[None].repeat(b, 1)
        vis = vis & (qs[:, :, None] == ks[:, None, :])
    pairs = int(vis.sum()) * (1 if vis.shape[0] == b else b)
    return q, k, v, dout, qs, ks, pairs


def _gemv_case(torch, gen, timer, dmm, kind, name, b):
    """decode_matmul on one Llama-3-8B projection (SHAPES_8B[name]) at b
    activation rows against decode_matmul_reference: kind "int4_halves",
    "int8" or "dense" with bf16 x, or "int4_halves_f32" (float32 x, the
    CUDA-core kernel). Raises unless the relative max error is below
    2e-2; returns the errors, the kernel's time (L2 flushed), the plain
    version's, torch.matmul's on the weight dequantized and scaled ahead
    of time in x's dtype (the library yardstick), the byte bound and the
    share of it reached, and the split plan."""
    from paddle_tpu_torch.ops.qweight import QWeight
    K, N = SHAPES_8B[name]
    f32 = kind.endswith("_f32")
    wkind = kind[:-4] if f32 else kind
    dt = torch.float32 if f32 else torch.bfloat16
    x = torch.randn((b, K), generator=gen, device="cuda").to(dt)
    scale = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
    if wkind == "dense":
        w = (torch.randn((K, N), generator=gen, device="cuda")
             * 0.02).to(dt)
        wbytes = K * N * x.element_size()
    else:
        rows = K // 2 if wkind == "int4_halves" else K
        q = torch.randint(-128, 128, (rows, N), generator=gen,
                          device="cuda").to(torch.int8)
        w = QWeight(q, scale, wkind)
        wbytes = rows * N + N * 4
    out = dmm.decode_matmul(x, w)
    again = dmm.decode_matmul(x, w)
    ref = dmm.decode_matmul_reference(x, w)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs().max()
    rel = float(diff / ref.float().abs().max().clamp(min=1e-9))
    _require(rel < 2e-2, f"decode_matmul {kind} {name} b={b}: relative "
                         f"max error {rel}")
    _require(torch.equal(out, again),
             f"decode_matmul {kind} {name} b={b}: two runs differ")
    wl = w if wkind == "dense" else (dmm.dequantize(w) * scale).to(dt)
    splits, per = dmm.split_plan(None if wkind == "dense" else wkind, dt, b,
                                 K, N, torch.cuda.get_device_properties(
                                     0).multi_processor_count)
    case = {"kernel": "decode_matmul", "kind": kind, "shape": name, "b": b,
            "K": K, "N": N, "route": "cuda cores" if f32 else "tensor cores",
            "max_abs_err": float(diff), "rel_err": rel,
            "splits": splits, "rows_per_split": per,
            "ms": timer(lambda: dmm.decode_matmul(x, w), iters=20),
            "plain_ms": timer(lambda: dmm.decode_matmul_reference(x, w),
                              iters=3),
            "library_ms": timer(lambda: torch.matmul(x, wl), iters=20)}
    case["bound_ms"], case["bound_by"] = _bound(
        wbytes + x.numel() * x.element_size() + b * N * x.element_size(),
        2 * b * K * N, F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    case["vs_library"] = case["ms"] / case["library_ms"]
    return case


def _flash_counts(cfa):
    return {"flash_fwd": cfa.launches_fwd,
            "flash_bwd_dq": cfa.launches_dq,
            "flash_bwd_dkv": cfa.launches_dkv}


def _reset_flash(cfa):
    cfa.launches_fwd = cfa.launches_dq = cfa.launches_dkv = 0


def _ring_case(torch, gen, timer, name, sq, sk, causal, b=1, h=16, hk=8,
               d=128, dtype="bfloat16"):
    """The ring blocks against their plain versions on one block: the
    forward (out, lse) of flash_attention_with_lse, then
    flash_attention_bwd_block against the out and lse merged by
    _merge_pair from this block and a second, non-causal one (as a
    ring step's backward runs). Tolerance 2e-2 bf16, 1e-4 float32
    (absolute and relative for out and lse, relative max error for
    the grads); backward reruns bit-identical. Times the forward, the
    whole backward block, and its dq and dk/dv kernels apart, with the
    pieces of the dk/dv work list (bf16 at d 64/128)."""
    from paddle_tpu_torch.ops import flash_attention as pfa
    from paddle_tpu_torch.ops.cuda import flash_attention as cfa
    ring_mod = importlib.import_module(
        "paddle_tpu_torch.distributed.ring_attention")

    def flash_counts():
        return _flash_counts(cfa)

    def reset_flash():
        _reset_flash(cfa)

    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, dout = rnd(b, sq, h, d), rnd(b, sq, h, d)
    k, v, k2, v2 = (rnd(b, sk, hk, d) for _ in range(4))
    sc = d ** -0.5
    tol = 1e-4 if dtype == "float32" else 2e-2
    fwd = lambda: pfa.flash_attention_with_lse(  # noqa: E731
        q, k, v, causal, sc)
    reset_flash()
    out, lse = fwd()
    _require(flash_counts()["flash_fwd"] == 1,
             f"ring block {name}: the forward launched {flash_counts()}")
    r_out, r_lse = pfa.flash_attention_plain(q.float(), k.float(),
                                             v.float(), causal, sc)
    err = {"out": float((out.float() - r_out).abs().max()),
           "lse": float((lse - r_lse).abs().max())}
    for got, ref, what in ((out.float(), r_out, "out"),
                           (lse, r_lse, "lse")):
        _require(torch.allclose(got, ref, atol=tol, rtol=tol),
                 f"ring block {name}: {what} differs from the plain "
                 f"version by {err[what]}")
    o2, l2 = pfa.flash_attention_with_lse(q, k2, v2, False, sc)
    m_out, m_lse = ring_mod._merge_pair(out, lse, o2, l2)
    m_out = m_out.to(dt)
    bwd_args = (q, k, v, m_out, m_lse, dout, causal, sc)
    reset_flash()
    runs = [pfa.flash_attention_bwd_block(*bwd_args) for _ in range(2)]
    torch.cuda.synchronize()
    _require(flash_counts() == {"flash_fwd": 0, "flash_bwd_dq": 2,
                                "flash_bwd_dkv": 2},
             f"ring block {name}: two backwards launched "
             f"{flash_counts()}")
    _require(all(torch.equal(a, b_) for a, b_ in zip(*runs)),
             f"ring block {name}: two backward runs differ")
    refs = pfa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), m_out.float(), m_lse,
        dout.float(), causal, sc)
    rel = {}
    for got, ref, what in zip(runs[0], refs, ("dq", "dk", "dv")):
        rel[what] = float((got.float() - ref).abs().max()
                          / ref.abs().max().clamp(min=1e-9))
        err[what] = float((got.float() - ref).abs().max())
        _require(rel[what] < tol, f"ring block {name}: {what} "
                                  f"relative max error {rel[what]}")
    _require(not any(bool(torch.isnan(t).any())
                     for t in (out, lse, *runs[0])),
             f"ring block {name}: NaN in an output")
    del r_out, r_lse, refs
    delta = cfa.flash_bwd_delta(m_out, dout)
    kern_args = (q, k, v, dout, m_lse, delta, causal, sc)
    ms = {"fwd": timer(fwd),
          "bwd": timer(lambda: pfa.flash_attention_bwd_block(*bwd_args)),
          "dq": timer(lambda: cfa.flash_bwd_dq_cuda(*kern_args)),
          "dkv": timer(lambda: cfa.flash_bwd_dkv_cuda(*kern_args))}
    split = None
    if dtype == "bfloat16" and d in (64, 128):
        rows = cfa.flash_schedule(
            "dkv", b, sq, sk, h, hk, causal, False,
            torch.cuda.get_device_properties(0).multi_processor_count)
        per_tile = cfa.dkv_pieces(rows, sk)
        split = {"dkv_rows": int(rows.shape[0]),
                 "pieces": int(per_tile.max()),
                 "pieces_per_key_tile": per_tile.tolist()}
    with torch.no_grad():
        plain = {
            "fwd": timer(lambda: pfa.flash_attention_plain(
                q, k, v, causal, sc), iters=3),
            "bwd": timer(lambda: pfa.flash_attention_bwd_plain(
                *bwd_args), iters=3)}
    lib = {"fwd": None, "bwd": None}
    if dtype == "bfloat16" and (sq == sk or not causal):
        # the yardstick only, never on the path: PyTorch's flash
        # attention with k/v repeated to h heads, its backward given
        # this block's merged out and lse
        aten = torch.ops.aten
        qt, dot_ = q.transpose(1, 2), dout.transpose(1, 2)
        kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                  for t in (k, v))
        lib["fwd"] = timer(lambda: aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=sc))
        res = aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=sc)
        mo = m_out.transpose(1, 2)
        lib["bwd"] = timer(
            lambda: aten._scaled_dot_product_flash_attention_backward(
                dot_, qt, kt, vt, mo, m_lse, res[2], res[3], sq, sk,
                0.0, causal, res[6], res[7], scale=sc))
        del res, kt, vt
    # least time: each input read once, each output written once;
    # products on the visible pairs (s, p.v forward; s, dp, dv, dq,
    # dk backward)
    pairs = b * (sq * (sq + 1) // 2 if causal else sq * sk)
    hp = pairs * h
    e_q = q.numel() * q.element_size()
    e_kv = k.numel() * k.element_size()
    rows = b * h * sq * 4
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    bound = {"fwd": _bound(2 * e_q + 2 * e_kv + rows, 4 * d * hp, rate),
             "bwd": _bound(4 * e_q + 2 * e_kv + rows + 8 * k.numel(),
                           10 * d * hp, rate)}
    flops = {"fwd": 4 * d * hp, "bwd": 14 * d * hp}  # dq + dk/dv
    return {"kernel": "ring_block", "case": name,
            "shape": dict(b=b, sq=sq, sk=sk, h=h, hk=hk, d=d,
                          causal=causal, dtype=dtype),
            "tflops": {k_: flops[k_] / (ms[k_] * 1e-3) / 1e12
                       for k_ in flops},
            "bound_share": {k_: bound[k_][0] / ms[k_] for k_ in bound},
            "sdpa_ratio": {k_: ms[k_] / lib[k_] for k_ in lib
                           if lib[k_] is not None},
            # the two kernels alone (no delta pass or copies) against
            # SDPA's backward
            "dq_dkv_sdpa_ratio": None if lib["bwd"] is None
            else (ms["dq"] + ms["dkv"]) / lib["bwd"],
            "dkv_split": split,
            "tolerance": tol, "max_abs_err": err, "grad_rel_err": rel,
            "bwd_bit_identical": True, "ms": ms, "plain_ms": plain,
            "library_ms": lib,
            "bound_ms": {k_: b_[0] for k_, b_ in bound.items()},
            "bound_by": {k_: b_[1] for k_, b_ in bound.items()}}



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


def _ragged_rows_case(torch, gen, decode_ctx, prefill=None, nh=32, kvh=8,
                      d=128, bs=64, max_pages=128):
    """A ragged batch in the engine's layout at the 8B attention shapes:
    one decode row per sequence at decode_ctx, then, with prefill =
    (rows, offset), that many prefill rows of one more sequence at
    offsets offset .. offset + rows - 1 (row_ctx offset + 1 ..). Every
    sequence's visible pages distinct, the rest of its table pointing
    anywhere. Also the bytes the function must move (q and out once,
    each sequence's visible K/V rows of each kv-head once, the table
    entries they take, row_seq / row_ctx) and its flops."""
    dev = "cuda"
    n_dec = len(decode_ctx)
    seq_ctx = list(decode_ctx) + ([prefill[0] + prefill[1]] if prefill
                                  else [])
    need = [-(-c // bs) for c in seq_ctx]
    nb = sum(need) + 1
    perm = torch.randperm(nb, generator=gen, device=dev).tolist()
    tables = torch.randint(0, nb, (len(seq_ctx), max_pages), generator=gen,
                           device=dev, dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(perm[at:at + n], device=dev,
                                     dtype=torch.int32)
        at += n
    row_seq = list(range(n_dec))
    row_ctx = list(decode_ctx)
    if prefill:
        row_seq += [n_dec] * prefill[0]
        row_ctx += [prefill[1] + 1 + j for j in range(prefill[0])]
    rows = len(row_seq)
    q = torch.randn((rows, nh, d), generator=gen, device=dev) \
        .to(torch.bfloat16)
    k, v = (torch.randn((nb, kvh, bs, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    nbytes = 2 * q.numel() * 2 + 2 * sum(seq_ctx) * kvh * d * 2 \
        + 4 * sum(need) + 8 * rows
    flops = 4 * nh * d * sum(row_ctx)
    args = (q, k, v, tables,
            torch.tensor(row_seq, dtype=torch.int32, device=dev),
            torch.tensor(row_ctx, dtype=torch.int32, device=dev))
    return args, nbytes, flops


def _sdpa_ms(torch, timer, q, k, v, tables, ctx):
    """The yardstick of a case whose rows are one sequence each and all
    see ctx positions: torch's scaled_dot_product_attention over the same
    K/V rows gathered beforehand into contiguous [b, kv_heads, ctx, d]
    (enable_gqa). Not paged, so not the same function: the port never
    calls it."""
    import torch.nn.functional as F
    b, nh, d = q.shape
    _, kvh, bs, _ = k.shape
    idx = tables[:b, :-(-ctx // bs)].long()

    def gather(pool):
        x = pool[idx]                      # [b, pages, kvh, bs, d]
        return x.permute(0, 2, 1, 3, 4).reshape(b, kvh, -1, d)[:, :, :ctx] \
            .contiguous()

    kc, vc, qq = gather(k), gather(v), q[:, :, None, :].contiguous()
    return timer(lambda: F.scaled_dot_product_attention(
        qq, kc, vc, enable_gqa=True), iters=20)


# ragged attention cases: the 8B smoke batch (24 decode rows at ctx up to
# 2048, a 64-row prefill chunk, 8 padding rows) with a bf16 and an int8
# pool; the pure-decode ministep of decode_ministep (W 8, ctx 512); an
# idle-engine prefill rung (8 decode rows at ctx 512, then 128 rows of one
# sequence at offset 384); and the smoke batch's layout at head_dim 64
# with pages smaller than a stage: int8 at group 2, bf16 at group 8
RAGGED_CASES = [
    dict(name="smoke_bf16"),
    dict(name="smoke_int8", quantized=True),
    dict(name="ragged_decode_w8_ctx512", decode=[512] * 8),
    dict(name="ragged_prefill_128", decode=[512] * 8, prefill=(128, 384)),
    dict(name="int8_d64_bs32_g2", quantized=True,
         geom=dict(nh=8, kvh=4, d=64, bs=32, max_ctx=1024)),
    dict(name="bf16_d64_bs16_g8",
         geom=dict(nh=16, kvh=2, d=64, bs=16, max_ctx=512)),
]


def _attention_plan(torch, q, pool, tables):
    """(KV splits a unit may take, deep ring, grid blocks a kv-head) the
    wrappers hand this call's kernel ((1, False, rows) on the CUDA-core
    route)."""
    from paddle_tpu_torch.ops.cuda.paged_attention_plan import (
        grid_plan, tensor_core_route)
    nb, kvh, bs, d = pool.shape
    if not tensor_core_route(q.dtype, d, bs):
        return 1, False, q.shape[0]
    return grid_plan(q.shape[0], kvh, tables.shape[1], bs,
                     torch.cuda.get_device_properties(0).multi_processor_count)


def _ragged_check(torch, gen, timer, spec):
    """The ragged kernel against ragged_paged_attention_reference on one
    case of RAGGED_CASES: raises unless the outputs agree within 1e-2
    absolute and relative (bf16 outputs; an int8 pool's p * v_scale is
    rounded to bf16 like p itself), hold no NaN, are exact zeros on rows
    with ctx <= 0, and two runs are bit-identical; returns the case's
    error, split count, times (L2 flushed before each launch) beside its
    bound and, for rows that all see one ctx, SDPA's time over the same
    rows gathered beforehand (not paged)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    quantized = spec.get("quantized", False)
    if "decode" in spec:
        args, nbytes, flops = _ragged_rows_case(torch, gen, spec["decode"],
                                                spec.get("prefill"))
    else:
        args, nbytes, flops = _attention_case(torch, gen, quantized,
                                              **spec.get("geom", {}))

    def kern():
        return rpa.ragged_paged_attention_cuda(*args)

    out, again = kern(), kern()
    ref = pa.ragged_paged_attention_reference(*args)
    torch.cuda.synchronize()
    name = spec["name"]
    err = float((out.float() - ref.float()).abs().max())
    tol = 1e-2
    _require(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
             f"ragged_paged_attention {name} differs from its plain "
             f"version: max abs err {err}")
    _require(not bool(torch.isnan(out).any()),
             f"ragged_paged_attention {name}: NaN")
    _require(torch.equal(out, again),
             f"ragged_paged_attention {name}: two runs differ")
    pad = args[5] <= 0
    _require(bool((out[pad] == 0).all()),
             f"ragged_paged_attention {name}: rows with ctx <= 0 are not "
             f"exact zeros")
    q, k = args[0], args[1]
    pool = k[0] if quantized else k
    case = {"kernel": "ragged_paged_attention", "case": name,
            "pool": "int8" if quantized else "bf16",
            "rows": int(q.shape[0]), "tolerance": tol, "max_abs_err": err,
            "zero_rows": int(pad.sum()),
            "plan": _attention_plan(torch, q, pool, args[3]),
            "ms": timer(kern, iters=20),
            "plain_ms": timer(
                lambda: pa.ragged_paged_attention_reference(*args),
                iters=3),
            "library_ms": None}
    case["bound_ms"], case["bound_by"] = _bound(nbytes, flops)
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    ctx = spec.get("decode", [])
    if ctx and "prefill" not in spec and len(set(ctx)) == 1:
        case["library_ms"] = _sdpa_ms(torch, timer, q, k, args[2], args[3],
                                      ctx[0])
        case["library_note"] = ("not paged: SDPA over the same K/V rows "
                                "gathered beforehand")
    return case


# paged decode attention cases: the 8B decode step (b 8 at ctx 512, the
# kernels line's row), generate()'s last step (b 4 at ctx 287), the ctx
# values of a serving run with a ctx-0 row, a float32 pool at d 64 /
# bs 16, head_dim 256, the int8-pool route (the ragged kernel with one
# row per sequence), and bf16 at d 64 / bs 16 (four pages a stage)
DECODE_CASES = [
    dict(name="8b_b8_ctx512", ctx=[512] * 8),
    dict(name="8b_b4_ctx287", ctx=[287] * 4),
    dict(name="8b_ctx_mix", ctx=[1, 37, 512, 600, 2100, 0, 129, 64]),
    dict(name="f32_d64_bs16", ctx=[1, 17, 200, 1000], nh=8, kvh=2, d=64,
         bs=16, max_pages=64, dtype="float32"),
    dict(name="d256", ctx=[5, 300, 1000, 2048], nh=16, kvh=2, d=256,
         max_pages=32),
    dict(name="int8_route", ctx=[512] * 8, quantized=True),
    dict(name="bf16_d64_bs16", ctx=[1, 17, 200, 1000], nh=8, kvh=2, d=64,
         bs=16, max_pages=64),
]


def _decode_case(torch, gen, ctx, nh=32, kvh=8, d=128, bs=64,
                 max_pages=128, dtype="bfloat16", quantized=False,
                 name=""):
    """One-token decode attention inputs at the 8B shapes unless named:
    every sequence's visible pages distinct, the rest of its table
    pointing anywhere. Also the bytes the function must move (q and out
    once, each visible K/V position of each kv-head once, scales
    included, the table entries it reads, the lengths) and its flops."""
    dev = "cuda"
    b = len(ctx)
    need = [-(-c // bs) for c in ctx]
    nb = sum(need) + 1
    perm = torch.randperm(nb, generator=gen, device=dev).tolist()
    tables = torch.randint(0, nb, (b, max_pages), generator=gen,
                           device=dev, dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(perm[at:at + n], device=dev,
                                     dtype=torch.int32)
        at += n
    dt = getattr(torch, dtype)
    q = torch.randn((b, nh, d), generator=gen, device=dev).to(dt)

    def plane():
        if quantized:
            return (torch.randint(-127, 128, (nb, kvh, bs, d), generator=gen,
                                  device=dev).to(torch.int8),
                    (torch.rand((nb, kvh, bs), generator=gen, device=dev)
                     * 0.05 + 0.001))
        return torch.randn((nb, kvh, bs, d), generator=gen, device=dev) \
            .to(dt)

    k, v = plane(), plane()
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    pos = sum(min(max(c, 0), max_pages * bs) for c in ctx)
    per_pos = kvh * d * (1 if quantized else q.element_size()) \
        + (kvh * 4 if quantized else 0)
    nbytes = 2 * q.numel() * q.element_size() + 2 * pos * per_pos \
        + 4 * sum(need) + 4 * b
    flops = 4 * nh * d * pos
    return (q, k, v, tables, ctx_t), nbytes, flops


def _decode_check(torch, gen, timer, spec):
    """The paged decode kernel (for an int8 pool, the dispatcher's ragged
    route) against paged_attention_decode_reference on one case of
    DECODE_CASES: raises unless the outputs agree within the stated
    tolerance (1e-4 float32, 1e-2 bf16, absolute and relative), hold no
    NaN and are exact zeros on ctx-0 rows; returns the case's errors and
    times (L2 flushed before each launch) beside its bound."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import paged_attention_decode as pdc
    args, nbytes, flops = _decode_case(torch, gen, **spec)
    quantized = spec.get("quantized", False)
    f32 = spec.get("dtype") == "float32"
    if quantized:
        def kern():
            return pa.paged_attention_decode(*args)
    else:
        def kern():
            return pdc.paged_attention_decode_cuda(*args)
    out, again = kern(), kern()
    ref = pa.paged_attention_decode_reference(*args)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = 1e-4 if f32 else 1e-2
    _require(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
             f"paged_attention_decode {spec['name']} differs from its "
             f"plain version: max abs err {err}")
    _require(not bool(torch.isnan(out).any()),
             f"paged_attention_decode {spec['name']}: NaN")
    _require(torch.equal(out, again),
             f"paged_attention_decode {spec['name']}: two runs differ")
    empty = args[4] <= 0
    _require(bool((out[empty] == 0).all()),
             f"paged_attention_decode {spec['name']}: ctx-0 rows are not "
             f"exact zeros")
    case = {"kernel": "paged_attention_decode", "case": spec["name"],
            "route": "ragged kernel (int8 pool)" if quantized
            else "decode kernel",
            "shape": {k: v for k, v in spec.items() if k != "name"},
            "tolerance": tol, "max_abs_err": err,
            "ctx0_rows_zero": int(empty.sum()),
            "plan": _attention_plan(
                torch, args[0], args[1][0] if quantized else args[1],
                args[3]),
            "ms": timer(kern, iters=20),
            "plain_ms": timer(
                lambda: pa.paged_attention_decode_reference(*args), iters=3),
            "library_ms": None}
    case["bound_ms"], case["bound_by"] = _bound(
        nbytes, flops, F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    ctx = spec["ctx"]
    if not quantized and len(set(ctx)) == 1:
        case["library_ms"] = _sdpa_ms(torch, timer, args[0], args[1],
                                      args[2], args[3], ctx[0])
        case["library_note"] = ("not paged: SDPA over the same K/V rows "
                                "gathered beforehand")
    return case


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    import numpy as np
    from paddle_tpu_torch.inference import (PagedLlamaDecoder,
                                            SamplingParams, ServingEngine)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_3_8b,
                                         llama_mid, llama_tiny)
    from paddle_tpu_torch.ops import flash_attention as pfa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import decode_matmul as dmm
    from paddle_tpu_torch.ops.cuda import flash_attention as cfa
    from paddle_tpu_torch.ops.cuda import paged_attention_decode as pdc
    from paddle_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.qweight import QWeight
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.distributed import fleet

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
        for src in ("flash_attention.cu", "flash_attention_wg.cu"):
            ptxas[src] = _flash_ptxas(
                _build.build_info.get("ptxas", {}).get(src, ""))
        ptxas["decode_matmul.cu"] = _gemv_ptxas(
            _build.build_info.get("ptxas", {}).get("decode_matmul.cu", ""))
        smem = {f"{kern}<{dn},{d}>": cfa.smem_bytes(kern, d, dt)
                for kern in ("fwd", "dq", "dkv") for d in cfa.HEAD_DIMS
                for dn, dt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16))}
        # the Hopper flash kernels' setmaxnreg 24/240 split over 384
        # threads waits forever below 168 registers a thread; a launch
        # refuses such a build, and so does this phase
        regs = {f"flash_wg::{kern}_kernel<bf16,{d}>": cfa.kernel_regs(kern, d)
                for kern in ("fwd", "dq", "dkv") for d in (64, 128)}
        _require(all(r >= 168 for r in regs.values()),
                 f"flash kernels built with fewer than 168 registers a "
                 f"thread: {regs}")
        for src in ("ragged_paged_attention.cu",
                    "paged_attention_decode.cu"):
            ptxas[src] = _paged_ptxas(
                _build.build_info.get("ptxas", {}).get(src, ""))
        paged_smem = {f"<{d},{'int8' if qz else 'bf16'}{',deep' if dp else ''}>":
                      rpa.smem_bytes(d, qz, dp) for d in (64, 128)
                      for qz in (False, True) for dp in (False, True)}
        sass = _sass(_build.BUILD_DIR / _build.build_info["library"])
        return {"build_s": round(_build.build_info["seconds"], 3),
                "library": _build.build_info["library"], "ptxas": ptxas,
                "flash_dynamic_smem_bytes": smem, "flash_wg_regs": regs,
                "paged_attention_dynamic_smem_bytes": paged_smem,
                "flash_wg_sass": _flash_sass(sass),
                "decode_matmul_sass": _gemv_sass(sass),
                "paged_attention_sass": _paged_sass(sass)}

    _phase("build", build)
    timer = _Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def counts():
        return {"ragged_paged_attention": rpa.launches,
                "decode_matmul": dmm.launches}

    def reset_counts():
        rpa.launches = 0
        dmm.launches = 0

    def flash_counts():
        return _flash_counts(cfa)

    def reset_flash():
        _reset_flash(cfa)

    # -- kernels against their plain versions --------------------------------
    def kernels():
        cases = []
        for spec in RAGGED_CASES:
            c = _ragged_check(torch, gen, timer, spec)
            cases.append(c)
            if spec["name"] in ("smoke_bf16", "smoke_int8"):
                heads[c["pool"]] = c
            torch.cuda.empty_cache()

        def gemv_case(kind, name, b):
            case = _gemv_case(torch, gen, timer, dmm, kind, name, b)
            cases.append(case)
            return case

        # b 4: generate()'s decode steps and the head product of a
        # grouped final (PREFILL_GROUP rows)
        for name in SHAPES_8B:
            for b in (1, 4, 8, 32):
                c = gemv_case("int4_halves", name, b)
                if name == "wgu" and b == 8:
                    heads["int4"] = c
        for kind in ("dense", "int8"):
            for b in (1, 8, 32):
                gemv_case(kind, "wgu", b)
        # float32 x: the CUDA-core kernel the tiny float32 models take
        gemv_case("int4_halves_f32", "wo", 8)
        for spec in DECODE_CASES:
            c = _decode_check(torch, gen, timer, spec)
            cases.append(c)
            if spec["name"] == "8b_b8_ctx512":
                heads["paged_decode"] = c
        for spec in FLASH_CASES:
            c = flash_case(**spec)
            cases.append(c)
            if spec["name"] == "llama_mid":
                heads["flash"] = c
            torch.cuda.empty_cache()
        for spec in RING_CASES:
            c = _ring_case(torch, gen, timer, **spec)
            cases.append(c)
            if spec["name"] == "earlier":
                heads["ring"] = c
            torch.cuda.empty_cache()
        # int4 and int8 against torch.matmul on the bf16 weight, and the
        # ring backward's two kernels against SDPA's backward, in this
        # run: reported; a timing is not a correctness check
        slow = [(c["kind"], c["shape"], c["b"], c["ms"], c["library_ms"])
                for c in cases if c["kernel"] == "decode_matmul"
                and c["kind"] in ("int4_halves", "int8")
                and c["ms"] > c["library_ms"]]
        ring = {c["case"]: c["dq_dkv_sdpa_ratio"] for c in cases
                if c["kernel"] == "ring_block"}
        return {"cases": cases, "gemv_slower_than_library": slow,
                "ring_dq_dkv_over_sdpa_bwd": ring}

    def flash_case(name, b, sq, sk, h, hk, d, docs=0, dtype="bfloat16"):
        """The three flash kernels against flash_attention_plain (float32
        leaves, autograd for the grads) on one causal case."""
        q, k, v, dout, qs, ks, pairs = _flash_inputs(
            torch, gen, b, sq, sk, h, hk, d, docs, dtype)
        sc = d ** -0.5
        fwd = lambda: cfa.flash_fwd_cuda(q, k, v, True, sc, qs, ks)  # noqa
        out, lse = fwd()
        delta = cfa.flash_bwd_delta(out, dout)
        bwd_args = (q, k, v, dout, lse, delta, True, sc, qs, ks)
        runs = [(cfa.flash_bwd_dq_cuda(*bwd_args),)
                + cfa.flash_bwd_dkv_cuda(*bwd_args) for _ in range(2)]
        (dq, dk, dv), again = runs
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b_) for a, b_ in zip(runs[0], again)),
                 f"flash {name}: two backward runs differ")
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        r_out, r_lse = pfa.flash_attention_plain(*leaves, True, sc, qs, ks)
        (r_out * dout.float()).sum().backward()
        r_out, r_lse = r_out.detach(), r_lse.detach()
        for got, ref, what in ((out.float(), r_out, "out"),
                               (lse, r_lse, "lse")):
            err = float((got - ref).abs().max())
            _require(torch.allclose(got, ref, atol=2e-2, rtol=2e-2),
                     f"flash {name}: {what} differs from the plain "
                     f"version by {err}")
        rel = {}
        for got, leaf, what in ((dq, leaves[0], "dq"), (dk, leaves[1], "dk"),
                                (dv, leaves[2], "dv")):
            ref = leaf.grad
            rel[what] = float((got.float() - ref).abs().max()
                              / ref.abs().max().clamp(min=1e-9))
            _require(rel[what] < 2e-2, f"flash {name}: {what} relative max "
                                       f"error {rel[what]}")
        _require(not any(bool(torch.isnan(t).any())
                          for t in (out, lse, dq, dk, dv)),
                 f"flash {name}: NaN in an output")
        masked = 0
        if qs is not None:
            pad = qs[0] == -1
            masked = int(pad.sum())
            _require(bool((out[:, pad] == 0).all())
                     and bool((dq[:, pad] == 0).all()),
                     f"flash {name}: fully-masked rows are not 0")
        err = {"fwd": float((out.float() - r_out).abs().max()),
               "dq": float((dq.float() - leaves[0].grad).abs().max()),
               "dkv": max(float((dk - leaves[1].grad).abs().max()),
                          float((dv - leaves[2].grad).abs().max()))}
        del leaves, r_out, r_lse
        ms = {"fwd": timer(fwd),
              "dq": timer(lambda: cfa.flash_bwd_dq_cuda(*bwd_args)),
              "dkv": timer(lambda: cfa.flash_bwd_dkv_cuda(*bwd_args))}
        # the plain version as a caller would run it: bf16 in, forward,
        # then its autograd backward (dq, dk and dv together)
        pl = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            plain_fwd = timer(lambda: pfa.flash_attention_plain(
                q, k, v, True, sc, qs, ks), iters=3)
        p_out = pfa.flash_attention_plain(*pl, True, sc, qs, ks)[0]
        plain_bwd = timer(lambda: torch.autograd.grad(
            p_out, pl, dout, retain_graph=True), iters=3)
        del p_out, pl
        lib = {"fwd": None, "dq": None, "dkv": None}
        if sq == sk and qs is None:
            # the yardstick only: one PyTorch call, never used by the port
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib["fwd"] = timer(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True))
            ll = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            l_out = sdpa(*ll, is_causal=True, enable_gqa=True)
            lib["dq"] = lib["dkv"] = timer(lambda: torch.autograd.grad(
                l_out, ll, dout.transpose(1, 2), retain_graph=True))
            del l_out, ll
        # least time: each input read once, each output written once;
        # products on this run's visible pairs (s, p.v forward; s, dp,
        # dq for dq; s, dp, dk, dv for dk/dv)
        hp = pairs * h
        e_q = q.numel() * q.element_size()
        e_kv = k.numel() * k.element_size()
        rows = b * h * sq * 4
        segb = 0 if qs is None else (qs.numel() + ks.numel()) * 4
        rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
        bound = {
            "fwd": _bound(2 * e_q + 2 * e_kv + rows + segb, 4 * d * hp,
                          rate),
            "dq": _bound(3 * e_q + 2 * e_kv + 2 * rows + segb, 6 * d * hp,
                         rate),
            "dkv": _bound(2 * e_q + 2 * e_kv + 2 * rows + 8 * k.numel()
                          + segb, 8 * d * hp, rate)}
        # achieved rate, share of the bound, and the time against the
        # same run's SDPA (forward; dq + dk/dv against its backward)
        flops = {"fwd": 4 * d * hp, "dq": 6 * d * hp, "dkv": 8 * d * hp}
        tflops = {k_: flops[k_] / (ms[k_] * 1e-3) / 1e12 for k_ in ms}
        share = {k_: bound[k_][0] / ms[k_] for k_ in ms}
        sdpa_ratio = None
        if lib["fwd"] is not None:
            sdpa_ratio = {"fwd": ms["fwd"] / lib["fwd"],
                          "bwd": (ms["dq"] + ms["dkv"]) / lib["dq"]}
        return {"kernel": "flash_attention", "case": name,
                "shape": dict(b=b, sq=sq, sk=sk, h=h, hk=hk, d=d,
                              docs=docs, causal=True, dtype=dtype),
                "tflops": tflops, "bound_share": share,
                "sdpa_ratio": sdpa_ratio,
                "visible_pairs_per_head": pairs, "masked_rows": masked,
                "max_abs_err": err, "grad_rel_err": rel,
                "bwd_bit_identical": True, "ms": ms,
                "plain_ms": {"fwd": plain_fwd, "dq": plain_bwd,
                             "dkv": plain_bwd},
                "library_ms": lib,
                "bound_ms": {k_: b_[0] for k_, b_ in bound.items()},
                "bound_by": {k_: b_[1] for k_, b_ in bound.items()}}

    heads = {}
    _phase("kernels", kernels)
    torch.cuda.empty_cache()

    def cpu_and_card(cfg):
        """A seeded int4 decoder on the CPU and the same weights on the
        card (64 blocks of 8)."""
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
        return cpu, gpu

    # -- tiny model: card against the CPU's plain path -----------------------
    def tiny_parity():
        cfg = llama_tiny()
        cpu, gpu = cpu_and_card(cfg)
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 12, 30)]
        outs = []
        reset_counts()
        for dec in (cpu, gpu):
            eng = ServingEngine(dec, ragged=True, max_batch_size=3,
                                chunk_size=4, prefill_chunk=8)
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

    def dense_counts():
        return {"paged_attention_decode": pdc.launches,
                "ragged_paged_attention": rpa.launches,
                "decode_matmul": dmm.launches,
                "flash_fwd": cfa.launches_fwd}

    def reset_dense():
        pdc.launches = rpa.launches = dmm.launches = 0
        reset_flash()

    def tiny_dense_parity():
        """The dense engine and generate() on the card against the CPU,
        at head_dim 64 (the flash and decode kernels take 64/128/256)."""
        cfg = llama_tiny(hidden_size=256)
        cpu, gpu = cpu_and_card(cfg)
        rng = np.random.RandomState(6)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 12, 30)]
        ids = rng.randint(0, cfg.vocab_size, (2, 16))
        outs, gens = [], []
        reset_dense()
        for dec in (cpu, gpu):
            eng = ServingEngine(dec, ragged=False, max_batch_size=3,
                                chunk_size=4, prefill_chunk=8,
                                prompt_buckets=(8, 16, 32))
            rids = [eng.add_request(p, SamplingParams(max_new_tokens=8))
                    for p in prompts]
            eng.run_to_completion()
            outs.append([eng.result(r).tolist() for r in rids])
            eng.close()
            dec.cache.debug_check()
            gens.append(dec.generate(ids, max_new_tokens=8).tolist())
        launched = dense_counts()
        _require(launched["paged_attention_decode"] > 0
                 and launched["decode_matmul"] > 0
                 and launched["flash_fwd"] > 0
                 and launched["ragged_paged_attention"] == 0,
                 f"tiny-dense-parity launched {launched}")
        # one prefill on identical rows of a fresh allocation
        logits = []
        row = rng.randint(0, cfg.vocab_size, (1, 16))
        for dec in (cpu, gpu):
            dev = dec.device
            dec.cache.allocate(100, 16)
            slots = [[dec.cache.extend(100) for _ in range(16)]]
            with torch.inference_mode():
                lg, _, _ = dec._prefill_impl(
                    dec.weights, dec.cache.k, dec.cache.v,
                    torch.as_tensor(row, dtype=torch.int32, device=dev),
                    torch.as_tensor(slots, dtype=torch.int32, device=dev))
            logits.append(lg.float().cpu())
            dec.cache.free(100)
        err = float((logits[0] - logits[1]).abs().max())
        _require(err < 1e-3, f"tiny-dense-parity prefill logits differ by "
                             f"{err}")
        _require(outs[0] == outs[1], f"tiny-dense-parity engine tokens "
                                     f"differ: cpu {outs[0]} vs cuda "
                                     f"{outs[1]}")
        _require(gens[0] == gens[1], f"tiny-dense-parity generate() "
                                     f"differs: cpu {gens[0]} vs cuda "
                                     f"{gens[1]}")
        return {"tokens_equal": True, "generate_equal": True,
                "prefill_logits_max_abs_err": err, "launches": launched}

    _phase("tiny-dense-parity", tiny_dense_parity)

    # -- the main path: 8B int4 serving --------------------------------------
    cfg = llama_3_8b(dtype="bfloat16")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, int(n))
               for n in rng.randint(100, 601, 8)]
    temps = [0.0] * 6 + [0.8] * 2

    def serve(dec, n_req, seed=0, ragged=True, reqs=None):
        """Serve n_req requests (serve-int4's prompts unless given) with
        32 new tokens each through a fresh engine on dec: (tokens, wall
        seconds, stats). The ragged engine takes prompts up to 1024."""
        if ragged:
            eng = ServingEngine(dec, ragged=True, max_batch_size=8,
                                prefill_chunk=256, chunk_size=8, seed=seed,
                                prompt_buckets=(32, 64, 128, 256, 512, 1024))
        else:
            eng = ServingEngine(dec, ragged=False, max_batch_size=8,
                                prefill_chunk=256, chunk_size=8, seed=seed)
        reqs = reqs or list(zip(prompts[:n_req], temps[-n_req:]))
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=32,
                                                  temperature=t))
                for p, t in reqs]
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

    def decode_ministep(dec, w=8, ctx=512, profile=True):
        """One pure-decode ministep of w rows at context ctx on real
        pages: (launch counts of one ministep, mean wall ms of a
        ministep including the greedy sample, its device time by kernel
        family per ministep, or None without ``profile``)."""
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
                torch, lambda: [ministep() for _ in range(n)], wall_ms * n) \
                if profile else None
        for sid in ids:
            cache.free(sid)
        if prof is None:
            return one, wall_ms, None
        for k in ("device_ms", "device_kernels", "wall_ms"):
            prof[k] /= n
        prof["device_ms_by_family"] = {
            k: v / n for k, v in prof["device_ms_by_family"].items()}
        prof["top_other"] = {k: v / n for k, v in prof["top_other"].items()}
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
                "decode_matmul_device_ms": {
                    "serving_run": serve_profile["device_ms_by_family"].get(
                        "decode_matmul"),
                    "decode_step": step_profile["device_ms_by_family"].get(
                        "decode_matmul")},
                "attention_device_ms": {
                    "serving_run": serve_profile["device_ms_by_family"].get(
                        "ragged_paged_attention"),
                    "decode_step": step_profile["device_ms_by_family"].get(
                        "ragged_paged_attention")},
                "decode_weight_floor_ms":
                    1e3 * weight_bytes / HBM_BYTES_PER_S,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "sample_tokens": outs1[0][:8].tolist()}
        shared["dec"] = dec
        shared["ragged_step"] = {"launches": one, "wall_ms": wall_ms,
                                 "device_ms": step_profile["device_ms"],
                                 "idle_share": step_profile["idle_share"]}
        return info

    shared = {}
    _phase("serve-int4", serve_int4)

    def dense_decode_step(dec, b=8, ctx=512, profile=True):
        """One dense decode step of b slots at context ctx on real pages:
        (launch counts of one step, mean wall ms of a step including the
        greedy sample, its device time by kernel family per step, or
        None without ``profile``)."""
        cache = dec.cache
        ids = list(range(2000, 2000 + b))
        for sid in ids:
            cache.allocate(sid, ctx + 1)
            for _ in range(ctx):
                cache.extend(sid)
        slots = [cache.extend(sid) for sid in ids]
        tables = np.stack([cache.block_table(sid, dec.max_pages)
                           for sid in ids])
        dev = dec.device
        args = (torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                              device=dev, dtype=torch.int32),
                torch.as_tensor(tables, device=dev),
                torch.full((b,), ctx, dtype=torch.int32, device=dev),
                torch.as_tensor(slots, dtype=torch.int32, device=dev))

        def step():
            lg, _, _ = dec._decode_logits(dec.weights, cache.k, cache.v,
                                          *args)
            return lg.argmax(dim=-1)

        with torch.inference_mode():
            reset_dense()
            step()
            torch.cuda.synchronize()
            one = dense_counts()
            t0 = time.perf_counter()
            n = 10
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            prof = _device_breakdown(
                torch, lambda: [step() for _ in range(n)], wall_ms * n) \
                if profile else None
        for sid in ids:
            cache.free(sid)
        if prof is None:
            return one, wall_ms, None
        for k in ("device_ms", "device_kernels", "wall_ms"):
            prof[k] /= n
        prof["device_ms_by_family"] = {
            k: v / n for k, v in prof["device_ms_by_family"].items()}
        prof["top_other"] = {k: v / n for k, v in prof["top_other"].items()}
        return one, wall_ms, prof

    def engines_alternated(dec, reqs, reps=4):
        """Both engines on the same requests, run alternately (ragged,
        dense, ragged, ...) reps times each, then their decode steps at
        8 rows and ctx 512 alternately 3 times each: per engine, each
        run's numbers and their median, min and max. The host's time
        drifts within a call, so only this interleaving compares them."""
        runs = {"ragged": [], "dense": []}
        for _ in range(reps):
            for name in runs:
                _, wall, st = serve(dec, 8, ragged=name == "ragged",
                                    reqs=reqs)
                runs[name].append({
                    "tok_per_s": st["generated_tokens"] / wall,
                    "ttft_p50_s": st["ttft_p50_s"],
                    "itl_p50_s": st["itl_p50_s"],
                    "itl_p99_s": st["itl_p99_s"]})
        steps = {"ragged": [], "dense": []}
        for _ in range(3):
            steps["ragged"].append(decode_ministep(dec, profile=False)[1])
            steps["dense"].append(dense_decode_step(dec, profile=False)[1])
        def spread(xs):
            return {"runs": xs, "median": float(np.median(xs)),
                    "min": min(xs), "max": max(xs)}

        return {name: dict({key: spread([r[key] for r in rs])
                            for key in rs[0]},
                           step_wall_ms=spread(steps[name]))
                for name, rs in runs.items()}

    dense_launches = {}

    def serve_dense_int4():
        """THE DENSE PATH: serve-int4's decoder (a decoder reused across
        engines keeps its scratch page) behind ServingEngine(ragged=
        False), then generate()."""
        dec = shared["dec"]
        drng = np.random.RandomState(1)
        reqs = list(zip([drng.randint(0, cfg.vocab_size, int(n))
                         for n in drng.randint(100, 513, 8)], temps))
        L = cfg.num_hidden_layers
        # every prefill dispatch of the run: (program, rows, logits)
        calls = []

        def counted(impl, kind):
            def run(weights, k_pool, v_pool, ids, *a, **k):
                calls.append((kind, ids.numel(), k.get("logits", True)))
                return impl(weights, k_pool, v_pool, ids, *a, **k)
            return run

        reset_dense()
        dec._prefill_impl = counted(dec._prefill_impl, "flash")
        dec._prefill_prefix_impl = counted(dec._prefill_prefix_impl,
                                           "prefix")
        try:
            outs1, wall1, st1 = serve(dec, 8, ragged=False, reqs=reqs)
        finally:
            del dec._prefill_impl, dec._prefill_prefix_impl
        dense_launches.update(dense_counts())
        n_flash = sum(kind == "flash" for kind, _, _ in calls)
        # GEMV launches: 4 L + 1 per decode step; a prefill dispatch of at
        # most 32 token rows sends its 4 L layer products to the GEMV
        # too, and a final (logits) its head product of <= 4 rows
        expect = {
            "paged_attention_decode": L * st1["decode_steps"],
            "ragged_paged_attention": 0,
            "decode_matmul": (4 * L + 1) * st1["decode_steps"] + sum(
                4 * L * (rows <= 32) + int(lg) for _, rows, lg in calls),
            "flash_fwd": L * n_flash}
        _require(dense_launches == expect,
                 f"the dense path ({st1['decode_steps']} decode steps, "
                 f"prefill dispatches {calls}) launched {dense_launches}, "
                 f"expected {expect}")
        outs2, wall2, st2 = serve(dec, 8, ragged=False, reqs=reqs)
        for i, (a, b) in enumerate(zip(outs1, outs2)):
            _require(np.array_equal(a, b),
                     f"dense request {i} (temperature {temps[i]}) differs "
                     f"between two runs with the same seed")
        serve_profile = _device_breakdown(
            torch, lambda: serve(dec, 8, ragged=False, reqs=reqs),
            wall2 * 1e3)
        one, wall_ms, step_profile = dense_decode_step(dec)
        _require(one == {"paged_attention_decode": 32, "decode_matmul": 129,
                         "ragged_paged_attention": 0, "flash_fwd": 0},
                 f"one dense decode step at mb 8 launched {one}, expected "
                 f"32 paged-decode and 129 GEMV kernels")
        gids = np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 256))
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_out = dec.generate(gids, max_new_tokens=32, timings=timings)
        gen_wall = time.perf_counter() - t0
        _require(gen_out.shape == (4, 288)
                 and np.array_equal(gen_out[:, :256], gids)
                 and gen_out.min() >= 0 and gen_out.max() < cfg.vocab_size,
                 f"generate() returned {gen_out.shape} with bad tokens")
        dec.cache.debug_check()
        alternated = engines_alternated(dec, reqs)
        info = {"model": "llama_3_8b int4 (halves), bf16 KV pool, 32 "
                         "layers, dense engine",
                "launches": dict(dense_launches),
                "decode_steps": st1["decode_steps"],
                "prefill_dispatches": calls,
                "wall_s": [wall1, wall2],
                "tok_per_s": st2["generated_tokens"] / wall2,
                "generated_tokens": st2["generated_tokens"],
                "device_dispatches": st2["device_dispatches"],
                "ttft_p50_s": st2["ttft_p50_s"],
                "itl_p50_s": st2["itl_p50_s"],
                "itl_p99_s": st2["itl_p99_s"],
                "time_prefill_s": st2["time_prefill_s"],
                "time_decode_stall_s": st2["time_decode_stall_s"],
                "time_host_s": st2["time_host_s"],
                "decode_utilization": st2["decode_utilization"],
                "decode_step_launches": one,
                "decode_step_mb8_ctx512_wall_ms": wall_ms,
                "decode_step_profile": step_profile,
                "ragged_ministep_same_call": shared["ragged_step"],
                "engines_alternated": alternated,
                "serve_profile": serve_profile,
                "decode_matmul_device_ms": {
                    "serving_run": serve_profile["device_ms_by_family"].get(
                        "decode_matmul"),
                    "decode_step": step_profile["device_ms_by_family"].get(
                        "decode_matmul")},
                "attention_device_ms": {
                    "serving_run": serve_profile["device_ms_by_family"].get(
                        "paged_attention_decode"),
                    "serving_run_flash_fwd": serve_profile[
                        "device_ms_by_family"].get("flash_fwd"),
                    "decode_step": step_profile["device_ms_by_family"].get(
                        "paged_attention_decode")},
                "generate_b4_p256_n32": {
                    "timings": timings, "wall_s": gen_wall,
                    "tok_per_s": 4 * 32 / gen_wall},
                "sample_tokens": outs1[0][:8].tolist()}
        del dec
        shared.clear()
        return info

    _phase("serve-dense-int4", serve_dense_int4)
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
        serve_profile = _device_breakdown(torch, lambda: serve(dec, 4),
                                          wall * 1e3)
        one, step_wall_ms, step_profile = decode_ministep(dec)
        _require(one == {"ragged_paged_attention": 32, "decode_matmul": 0},
                 f"one pure-decode ministep at W=8 with an int8 pool "
                 f"launched {one}, expected 32 attention kernels")
        del dec
        return {"model": "llama_3_8b bf16 weights, int8 KV pool, 32 layers",
                "launches": dict(kv8_launches),
                "tok_per_s": st["generated_tokens"] / wall, "wall_s": wall,
                "attention_device_ms": {
                    "serving_run": serve_profile["device_ms_by_family"].get(
                        "ragged_paged_attention"),
                    "decode_step": step_profile["device_ms_by_family"].get(
                        "ragged_paged_attention")},
                "serve_profile": serve_profile,
                "decode_ministep_W8_ctx512_wall_ms": step_wall_ms,
                "sample_tokens": outs[0][:8].tolist()}

    _phase("serve-bf16-kv8", serve_bf16_kv8)
    gc.collect()
    torch.cuda.empty_cache()

    # -- tiny model training: card against the CPU's plain path --------------
    def tiny_train_parity():
        cfg = llama_tiny(hidden_size=256)          # head_dim 64
        cpu = LlamaForCausalLM(cfg, seed=3, device="cpu")
        gpu = LlamaForCausalLM(cfg, seed=3, device="cuda")
        gpu.load_numpy_state({n: p.detach().numpy()
                              for n, p in cpu.named_parameters()})
        ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 100))
        losses = []
        reset_flash()
        for m in (cpu, gpu):
            step = TrainStep(m, m.loss, AdamW(learning_rate=1e-3,
                                              parameters=m.parameters()))
            x = torch.as_tensor(ids, dtype=torch.int32,
                                device=m.lm_head.weight.device)
            losses.append([float(step(x, x)) for _ in range(3)])
        launched = flash_counts()
        _require(all(v > 0 for v in launched.values()),
                 f"tiny-train-parity did not launch every flash kernel: "
                 f"{launched}")
        rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
        _require(rel < 1e-4, f"tiny-train-parity losses differ: cpu "
                             f"{losses[0]} vs cuda {losses[1]}")
        return {"losses_cpu": losses[0], "losses_cuda": losses[1],
                "max_rel_diff": rel, "launches": launched}

    _phase("tiny-train-parity", tiny_train_parity)

    def sep_fleet(sep, device):
        """A sep-`sep` fleet mesh with every rank on `device`."""
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"sep_degree": sep}
        return fleet.init(is_collective=True, strategy=strategy,
                          devices=[device] * sep)

    # -- tiny context-parallel training: card against the CPU ---------------
    def tiny_ring_parity():
        b, s, steps, sep = 2, 256, 3, 4
        cfg = llama_tiny(hidden_size=256, sep_degree=sep)   # head_dim 64
        ids = np.random.RandomState(9).randint(0, cfg.vocab_size, (b, s))
        cpu = LlamaForCausalLM(cfg, seed=3, device="cpu")
        state = {n: p.detach().numpy().copy()
                 for n, p in cpu.named_parameters()}
        runs, launched = {}, {}
        for name, c, device in (("cpu", cfg, "cpu"),
                                ("cuda", cfg, "cuda:0"),
                                ("cuda_sep1", llama_tiny(hidden_size=256),
                                 "cuda:0")):
            fleet._hcg = None
            if c.sep_degree > 1:
                sep_fleet(sep, device)
            m = cpu if device == "cpu" else \
                LlamaForCausalLM(c, seed=0, device="cuda")
            m.load_numpy_state(state)
            step = TrainStep(m, m.loss, AdamW(learning_rate=1e-3,
                                              parameters=m.parameters()))
            x = torch.as_tensor(ids, dtype=torch.int32, device=device)
            reset_flash()
            runs[name] = [float(step(x, x)) for _ in range(steps)]
            launched[name] = flash_counts()
        fleet._hcg = None
        per_step = cfg.num_hidden_layers * sep * (sep + 2)
        _require(launched["cpu"] == {k_: 0 for k_ in launched["cpu"]},
                 f"the CPU run launched kernels: {launched['cpu']}")
        _require(launched["cuda"] == {k_: per_step * steps
                                      for k_ in launched["cuda"]},
                 f"tiny-ring-parity launched {launched['cuda']}, expected "
                 f"{per_step} of each flash kernel per step")
        _require(launched["cuda_sep1"] == {
            k_: cfg.num_hidden_layers * steps for k_ in launched["cuda"]},
            f"the sep-1 run launched {launched['cuda_sep1']}")

        def rel(a, b_):
            return max(abs(x - y) / abs(x) for x, y in zip(a, b_))

        diff = {"cuda_vs_cpu": rel(runs["cpu"], runs["cuda"]),
                "sep4_vs_sep1": rel(runs["cuda_sep1"], runs["cuda"])}
        _require(max(diff.values()) < 1e-4,
                 f"tiny-ring-parity losses differ: {runs}")
        return {"losses": runs, "max_rel_diff": diff, "launches": launched}

    _phase("tiny-ring-parity", tiny_ring_parity)

    # -- the training path: llama_mid at full width ---------------------------
    train_launches = {}

    def train_mid():
        cfg = llama_mid(dtype="bfloat16")
        b, s, warm, iters = 4, 2048, 2, 10
        t0 = time.perf_counter()
        model = LlamaForCausalLM(cfg, seed=0, device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, model.loss, opt)
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(b, s)).astype(np.int32), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_flash()
        losses = [step(ids, ids) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids, ids) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches.update(flash_counts())
        serving = counts()
        n_steps = warm + iters
        L = cfg.num_hidden_layers
        _require(train_launches == {k_: L * n_steps for k_ in train_launches},
                 f"{n_steps} steps launched {train_launches}, expected "
                 f"{L} of each flash kernel per step")
        _require(all(v == 0 for v in serving.values()),
                 f"training launched serving kernels: {serving}")
        losses = [float(x) for x in losses]
        _require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        _require(losses[-1] < losses[0],
                 f"the loss did not fall: {losses[0]} -> {losses[-1]}")
        step_ms = wall * 1e3 / iters
        tok_s = b * s * iters / wall
        n_params = model.num_params()
        fpt = 6 * n_params + 12 * L * cfg.num_attention_heads * (
            cfg.hidden_size // cfg.num_attention_heads) * s
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_prof = 2
        prof = _device_breakdown(
            torch, lambda: [step(ids, ids) for _ in range(n_prof)],
            step_ms * n_prof)
        for k_ in ("device_ms", "device_kernels", "wall_ms"):
            prof[k_] /= n_prof
        prof["device_ms_by_family"] = {
            k_: v / n_prof for k_, v in prof["device_ms_by_family"].items()}
        prof["top_other"] = {k_: v / n_prof
                             for k_, v in prof["top_other"].items()}
        del model, opt, step
        return {"model": "llama_mid bf16 compute (float32 Linear/Embedding "
                         "weights), 11 layers, b4 x s2048, AdamW(1e-4, "
                         "wd 0.01)",
                "num_params": n_params, "init_s": init_s,
                "launches": dict(train_launches), "steps": n_steps,
                "losses": losses, "step_ms": step_ms, "tokens_per_s": tok_s,
                "mfu": tok_s * fpt / BF16_FLOPS_PER_S,
                "flops_per_token": fpt, "peak_mem_gb": peak_gb,
                "nvidia_smi": smi, "step_profile": prof}

    _phase("train-mid", train_mid)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the long-context path: llama_mid at s 8192, zigzag ring over sep 4 --
    long_launches = {}

    def train_mid8k():
        b, s, sep, warm, iters = 1, 8192, 4, 2, 5
        cfgs = {n: llama_mid(dtype="bfloat16", chunked_ce_tokens=1024,
                             max_position_embeddings=8192, sep_degree=n)
                for n in (sep, 1)}
        L, H = cfgs[1].num_hidden_layers, cfgs[1].num_attention_heads
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfgs[1].vocab_size, size=(b, s)).astype(np.int32),
            device="cuda")
        sep_fleet(sep, "cuda:0")
        steps = {}

        def build(n):
            model = LlamaForCausalLM(cfgs[n], seed=0, device="cuda")
            opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                        weight_decay=0.01)
            steps[n] = (model, TrainStep(model, model.loss, opt))

        t0 = time.perf_counter()
        build(sep)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step4 = steps[sep][1]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_flash()
        losses = [step4(ids, ids) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step4(ids, ids) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        long_launches.update(flash_counts())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_steps = warm + iters
        per_step = L * sep * (sep + 2)
        _require(long_launches == {k_: per_step * n_steps
                                   for k_ in long_launches},
                 f"{n_steps} steps launched {long_launches}, expected "
                 f"{per_step} of each flash kernel per step")
        _require(all(v == 0 for v in counts().values()),
                 f"training launched serving kernels: {counts()}")
        losses = [float(x) for x in losses]
        _require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        _require(losses[-1] < losses[0],
                 f"the loss did not fall: {losses[0]} -> {losses[-1]}")
        # sep 1 on the same ids (the same weights from the same seed): its
        # first step against sep 4's, then the two alternated (each run 2
        # steps, launches checked per run)
        build(1)
        reset_flash()
        first1 = float(steps[1][1](ids, ids))
        _require(flash_counts() == {k_: L for k_ in long_launches},
                 f"a sep-1 step launched {flash_counts()}")
        first_rel = abs(first1 - losses[0]) / abs(losses[0])
        _require(first_rel < 1e-2, f"first-step losses differ: sep 1 "
                                   f"{first1}, sep 4 {losses[0]}")
        alt = {1: [], sep: []}
        for _ in range(3):
            for n in (1, sep):
                reset_flash()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(2):
                    steps[n][1](ids, ids)
                torch.cuda.synchronize()
                alt[n].append((time.perf_counter() - t1) * 1e3 / 2)
                per = L if n == 1 else per_step
                _require(flash_counts() == {k_: 2 * per
                                            for k_ in long_launches},
                         f"an alternated sep-{n} run launched "
                         f"{flash_counts()}")
        n_params = steps[1][0].num_params()
        fpt = 6 * n_params + 12 * L * H * (
            cfgs[1].hidden_size // H) * s
        step_ms = wall * 1e3 / iters

        def spread(xs):
            xs = sorted(xs)
            return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}

        def profile(n):
            wall_ms = spread(alt[n])["median"]
            prof = _device_breakdown(
                torch, lambda: [steps[n][1](ids, ids) for _ in range(2)],
                wall_ms * 2)
            for k_ in ("device_ms", "device_kernels", "wall_ms"):
                prof[k_] /= 2
            for k_ in ("device_ms_by_family", "top_other"):
                prof[k_] = {a: v / 2 for a, v in prof[k_].items()}
            return prof

        profs = {f"sep{n}": profile(n) for n in (sep, 1)}
        del steps
        fleet._hcg = None
        return {"model": "llama_mid bf16 compute, 11 layers, chunked CE "
                         "1024, b1 x s8192, AdamW(1e-4, wd 0.01), sep 4 "
                         "zigzag ring on cuda:0 x 4",
                "num_params": n_params, "init_s": init_s,
                "launches": dict(long_launches), "steps": n_steps,
                "losses": losses, "step_ms": step_ms,
                "tokens_per_s": b * s / (step_ms / 1e3),
                "mfu": b * s / (step_ms / 1e3) * fpt / BF16_FLOPS_PER_S,
                "flops_per_token": fpt, "peak_mem_gb": peak_gb,
                "first_step_loss": {"sep1": first1, "sep4": losses[0],
                                    "rel_diff": first_rel},
                "alternated_step_ms": {f"sep{n}": spread(v)
                                       for n, v in alt.items()},
                "alternated_mfu": {
                    f"sep{n}": b * s / (spread(v)["median"] / 1e3) * fpt
                    / BF16_FLOPS_PER_S for n, v in alt.items()},
                "alternated_runs_ms": {f"sep{n}": v for n, v in alt.items()},
                "nvidia_smi": smi, "step_profile": profs,
                "flash_device_ms": {
                    k_: sum(v for f, v in p_["device_ms_by_family"].items()
                            if f.startswith("flash"))
                    for k_, p_ in profs.items()}}

    _phase("train-mid8k", train_mid8k)

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
             tpu + "decode_matmul.py:135"),
            ("paged_decode", "paged_attention_decode",
             dense_launches["paged_attention_decode"],
             "paddle_tpu_torch/csrc/paged_attention_decode.cu",
             tpu + "paged_attention.py:125")):
        c = heads[key]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    f = heads["flash"]
    for key, name, rep in (
            ("fwd", "flash_fwd", tpu + "flash_attention.py:69"),
            ("dq", "flash_bwd_dq", tpu + "flash_attention.py:174"),
            ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:229")):
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_wg.cu",
            "replaces": rep, "launches": train_launches[name],
            "max_abs_err": f["max_abs_err"][key], "ms": f["ms"][key],
            "plain_ms": f["plain_ms"][key], "bound_ms": f["bound_ms"][key],
            "bound_by": f["bound_by"][key],
            "library_ms": f["library_ms"][key]})
    r = heads["ring"]
    for key, name, rep, launches in (
            ("fwd", "flash_attention_with_lse", tpu + "flash_attention.py:526",
             long_launches["flash_fwd"]),
            ("bwd", "flash_attention_bwd_block",
             tpu + "flash_attention.py:543", long_launches["flash_bwd_dq"])):
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_wg.cu",
            "replaces": rep, "launches": launches,
            "max_abs_err": max(v for k_, v in r["max_abs_err"].items()
                               if (k_ in ("out", "lse")) == (key == "fwd")),
            "ms": r["ms"][key], "plain_ms": r["plain_ms"][key],
            "bound_ms": r["bound_ms"][key], "bound_by": r["bound_by"][key],
            "library_ms": r["library_ms"][key]})
    _emit({"kernels": kernel_rows})
    print(smi, flush=True)
    _emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
