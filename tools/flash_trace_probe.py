#!/usr/bin/env python3
"""Which flash forward launches a torch.profiler trace of a training step
shows, set beside the launches the wrapper counts, on one CUDA card.

Run from the root of the repository:

    python3 tools/flash_trace_probe.py [--before sessions|graph|smoke]

``--before`` first puts the process in a state to compare: ``sessions``
runs 300 short profiler sessions (a flash forward and an add each, read
as chip_smoke.py reads a trace); ``graph`` captures a CUDA graph of a
flash forward and an add and replays it three times; ``smoke`` runs
chip_smoke.py's phases from ``kernels`` through ``train-dit-xl2`` in
this process (their lines are printed as the smoke prints them).

The model is bench.py's moe_ragged row (MoEConfig bf16, 8 layers,
hidden 1024, 16 / 8 heads of 64, E 8 top-2, chunked CE 1024, b 4 x s
2048, AdamW(1e-4)), warmed by two TrainSteps on one batch of ids. Every
traced step then runs on another batch, so an attention output that a
forward kernel did not write (memory left from an earlier step) shows as
an error. ``flash_fwd_cuda`` is wrapped for the probe: each call is
numbered, runs inside ``record_function("ptt_fwd_<n>")``, and keeps its
q, k, v and output, which are held against the plain version
(``flash_attention_plain``) after the trace ends.

Sessions (each one ``torch.profiler.profile``):
- ``cuda_1``: CUDA activity only, one step (as chip_smoke.py traces);
- ``cpu_cuda_1``: CPU and CUDA activity, one step: for each numbered
  call, its runtime launch (correlation id) and the kernel record with
  that id, if any;
- ``cuda_2``: CUDA activity only, two steps;
- ``cuda_1_sleep``: as ``cuda_1``, the card first sleeping about a
  quarter second so that the host queues the step ahead of it;
- ``cuda_bare``: CUDA activity only, eight forward calls of the flash
  kernel alone at the row's shape, each followed by an add.
Per session it prints one JSON line: the calls counted, the forward
kernel records, the correlation ids and start times of those records,
the runtime kernel launches and those with no device record (how many,
the index of the first and the last in launch order), for
``cpu_cuda_1`` each numbered call's launch, and the largest error of
each call's output over the largest |reference|. Every event of every
session goes to ``chiprun_out/flash_trace/<before>/<session>.json.gz``.
The card's name and power limit come first.
"""
import gzip
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


SMOKE_PHASES = (
    "kernels,tiny-parity,tiny-dense-parity,tiny-prefix-parity,"
    "tiny-rich-faults-parity,serve-int4,serve-dense-int4,serve-prefix-int4,"
    "serve-graphs,serve-rich-int4,serve-faults-int4,tiny-ms-spec-lora-parity,"
    "serve-ms-int4,serve-spec-int4,serve-lora-int4,tiny-fleet-parity,"
    "serve-telemetry-int4,fleet-int4,fleet-proc-int4,tiny-tp-parity,"
    "serve-tp2-int4,serve-bf16-kv8,tiny-train-parity,tiny-ring-parity,"
    "tiny-model-parity,train-mid,train-mid8k,train-1b,serve-model-1b,"
    "tiny-gpt-parity,serve-ernie-int4,train-gpt-345m,tiny-dit-parity,"
    "train-dit-xl2")


def main():
    import numpy as np
    import torch
    before = "none"
    if sys.argv[1:2] == ["--before"] and len(sys.argv) == 3:
        before = sys.argv[2]
    if before not in ("none", "sessions", "graph", "smoke"):
        print("usage: python3 tools/flash_trace_probe.py "
              "[--before sessions|graph|smoke]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_trace_probe: no CUDA device", file=sys.stderr)
        return 1
    if before == "smoke":
        import chip_smoke
        argv = sys.argv
        sys.argv = ["chip_smoke.py", "--only", SMOKE_PHASES]
        try:
            chip_smoke.main()
        except Exception as e:          # the probe runs on regardless
            print(json.dumps({"smoke_error": repr(e)[:400]}), flush=True)
        finally:
            sys.argv = argv
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa_ops
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "nvidia_smi": smi,
                      "before": before}), flush=True)
    out_dir = ROOT / "chiprun_out" / "flash_trace" / before
    out_dir.mkdir(parents=True, exist_ok=True)

    calls = []
    orig = fa.flash_fwd_cuda

    def numbered(q, k, v, causal, scale, q_seg=None, kv_seg=None):
        with record_function(f"ptt_fwd_{len(calls)}"):
            out, lse = orig(q, k, v, causal, scale, q_seg, kv_seg)
        calls.append((q, k, v, causal, scale, out))
        return out, lse

    fa.flash_fwd_cuda = numbered

    cfg = MoEConfig(dtype="bfloat16", hidden_size=1024,
                    intermediate_size=2816, moe_intermediate_size=1408,
                    num_hidden_layers=8, num_attention_heads=16,
                    num_key_value_heads=8, num_experts=8,
                    num_experts_per_tok=2, max_position_embeddings=2048,
                    chunked_ce_tokens=1024, moe_dispatch_mode="ragged")
    model = MoEForCausalLM(cfg, seed=0, device="cuda")
    step = TrainStep(model, model.loss, AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        weight_decay=0.01))
    rng = np.random.RandomState(0)

    def batch():
        return torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 2048))
                               .astype(np.int32), device="cuda")

    def bare(n=8):
        g = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(4, 2048, 16, 64, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        k = torch.randn(4, 2048, 8, 64, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        torch.cuda.synchronize()

        def run():
            x = q
            for _ in range(n):
                x = fa_ops.flash_attention(x, k, v, causal=True) + q
        return run

    warm = batch()
    for _ in range(2):
        step(warm, warm)
    torch.cuda.synchronize()
    if before == "sessions":
        run = bare(n=1)
        with torch.no_grad():
            for _ in range(300):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                list(prof.profiler.kineto_results.events())
    elif before == "graph":
        run = bare(n=1)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            run()
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                run()
            for _ in range(3):
                graph.replay()
        torch.cuda.synchronize()
    calls.clear()

    def train(n, sleep=False):
        ids = [batch() for _ in range(n)]
        torch.cuda.synchronize()

        def run():
            if sleep:
                torch.cuda._sleep(500_000_000)
            for i in ids:
                step(i, i)
        return run

    sessions = [("cuda_1", [ProfilerActivity.CUDA], train(1)),
                ("cpu_cuda_1", [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 train(1)),
                ("cuda_2", [ProfilerActivity.CUDA], train(2)),
                ("cuda_1_sleep", [ProfilerActivity.CUDA], train(1, True)),
                ("cuda_bare", [ProfilerActivity.CUDA], bare())]
    cuda = torch.autograd.DeviceType.CUDA
    for name, acts, fn in sessions:
        calls.clear()
        with torch.no_grad() if name == "cuda_bare" else _null():
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
        events = [{"dev": "cuda" if ev.device_type() == cuda else "cpu",
                   "name": ev.name()[:160], "corr": ev.correlation_id(),
                   "linked": ev.linked_correlation_id(),
                   "start_ns": ev.start_ns(), "dur_ns": ev.duration_ns(),
                   "tid": ev.start_thread_id()}
                  for ev in prof.profiler.kineto_results.events()]
        with gzip.open(out_dir / f"{name}.json.gz", "wt") as f:
            json.dump(events, f)
        fwd = sorted((e for e in events if e["dev"] == "cuda"
                      and "fwd_kernel" in e["name"]),
                     key=lambda e: e["start_ns"])
        t0 = min(e["start_ns"] for e in events)
        row = {"session": name, "calls_counted": len(calls),
               "fwd_kernel_records": len(fwd),
               "fwd_records": [[e["corr"], e["linked"],
                                (e["start_ns"] - t0) / 1e3] for e in fwd],
               "first_cuda_event_us": min(
                   ((e["start_ns"] - t0) / 1e3 for e in events
                    if e["dev"] == "cuda"), default=None),
               "cuda_events": sum(e["dev"] == "cuda" for e in events)}
        launches = sorted((e for e in events if e["dev"] == "cpu"
                           and "Launch" in e["name"]),
                          key=lambda e: e["start_ns"])
        recorded = {e["corr"] for e in events if e["dev"] == "cuda"}
        lost = [i for i, e in enumerate(launches)
                if e["corr"] not in recorded]
        row["launches"] = len(launches)
        row["launches_without_record"] = {
            "n": len(lost), "first": lost[:1], "last": lost[-1:]}
        if ProfilerActivity.CPU in acts:
            row["calls"] = _match_calls(events)
        errs = []
        for q, k, v, causal, scale, out in calls:
            ref, _ = fa_ops.flash_attention_plain(q, k, v, causal, scale)
            errs.append(float((out.float() - ref.float()).abs().max()
                              / ref.float().abs().max()))
        row["out_rel_err"] = errs
        print(json.dumps(row), flush=True)
    fa.flash_fwd_cuda = orig
    return 0


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _match_calls(events):
    """For each ptt_fwd_<n> range: the runtime launches inside it on its
    thread (name, correlation id) and the names of the kernel records
    that carry the same correlation id."""
    by_corr = {}
    for e in events:
        if e["dev"] == "cuda":
            by_corr.setdefault(e["corr"], []).append(e["name"][:60])
    out = []
    for r in sorted((e for e in events if e["name"].startswith("ptt_fwd_")),
                    key=lambda e: e["start_ns"]):
        end = r["start_ns"] + r["dur_ns"]
        launches = [e for e in events
                    if e["dev"] == "cpu" and e["tid"] == r["tid"]
                    and "Launch" in e["name"]
                    and r["start_ns"] <= e["start_ns"] <= end]
        out.append({"call": r["name"],
                    "launches": [[e["name"], e["corr"],
                                  by_corr.get(e["corr"], [])]
                                 for e in launches]})
    return out


if __name__ == "__main__":
    sys.exit(main())
