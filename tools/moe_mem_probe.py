#!/usr/bin/env python3
"""Where a full-width MoE training step holds its memory, stage by stage.

Run from the root of the repository on a CUDA card:

    python3 tools/moe_mem_probe.py {deepseek|qwen} DEPTH [expandable]

Builds ``deepseek_moe_16b_like`` or ``qwen2_moe_a14b_like`` at DEPTH
layers as chip_smoke.py's train-moe-full does (bf16, ragged dispatch,
chunked CE 1024, recompute "full"; AdamW β 0.9 / 0.95, weight decay 0.1,
LinearWarmup(MultiStepDecay), ClipGradForMOEByGlobalNorm(1.0); b 2 x s
4096 from RandomState(0)) and runs two eager steps. For each stage
(forward + loss, backward, the clip's expert / dense split, the AdamW
step with clear_grad) it prints the memory allocated after it and the
peaks allocated and reserved during it, in one JSON line. With
``expandable``, the allocator's expandable segments are turned on first
(set at run time, as a process that has already used the card would).
An out-of-memory error is reported in the line, not raised.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(name, depth, expandable, steps=2):
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm)
    from paddle_tpu_torch.models import (MoEForCausalLM,
                                         deepseek_moe_16b_like,
                                         qwen2_moe_a14b_like)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_sched

    if not torch.cuda.is_available():
        print("moe_mem_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.ones(1, device="cuda")
    if expandable:
        setter = getattr(torch._C, "_accelerator_setAllocatorSettings",
                         None) or torch.cuda.memory._set_allocator_settings
        setter("expandable_segments:True")
    fn = {"qwen": qwen2_moe_a14b_like,
          "deepseek": deepseek_moe_16b_like}[name]
    cfg = fn(dtype="bfloat16", moe_dispatch_mode="ragged",
             chunked_ce_tokens=1024, use_recompute=True,
             recompute_granularity="full", num_hidden_layers=depth)
    out = {"name": name, "depth": depth, "expandable": expandable,
           "device": torch.cuda.get_device_name(0),
           "free_at_start_gb": torch.cuda.mem_get_info()[0] / 1e9}
    try:
        model = MoEForCausalLM(cfg, seed=0, device="cuda")
        experts = {id(p) for n, p in model.named_parameters()
                   if ".moe.w1" in n or ".moe.w2" in n}
        clip = ClipGradForMOEByGlobalNorm(
            1.0, is_expert_param_func=lambda p: id(p) in experts)
        sched = lr_sched.LinearWarmup(
            lr_sched.MultiStepDecay(4.2e-4, milestones=[8, 9], gamma=0.316),
            warmup_steps=4, start_lr=0.0, end_lr=4.2e-4)
        params = list(model.parameters())
        opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                    weight_decay=0.1, parameters=params, grad_clip=clip)
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(2, 4096)).astype(np.int32),
            device="cuda")
        out["state_gb"] = 16 * sum(p.numel() for p in params) / 1e9
        stages = []
        for i in range(steps):
            for stage in ("fwd", "bwd", "split", "opt"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if stage == "fwd":
                    loss = model.loss(model(ids), ids)
                elif stage == "bwd":
                    loss.backward()
                elif stage == "split":
                    clip.partition_norms(params, [p.grad for p in params])
                else:
                    opt.step()
                    opt.clear_grad()
                    sched.step()
                torch.cuda.synchronize()
                stages.append({
                    "step": i, "stage": stage,
                    "alloc_gb": torch.cuda.memory_allocated() / 1e9,
                    "peak_alloc_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "peak_reserved_gb":
                        torch.cuda.max_memory_reserved() / 1e9})
        out.update(stages=stages, loss=float(loss.detach()), ok=True,
                   free_at_end_gb=torch.cuda.mem_get_info()[0] / 1e9,
                   reserved_gb=torch.cuda.memory_reserved() / 1e9)
    except torch.cuda.OutOfMemoryError as e:
        out.update(ok=False, oom=str(e).splitlines()[0][:300])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4) or sys.argv[1] not in ("deepseek",
                                                          "qwen"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], int(sys.argv[2]),
                  sys.argv[3:] == ["expandable"]))
