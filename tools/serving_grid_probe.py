#!/usr/bin/env python3
"""The cost of capturing a ragged serving engine's whole program grid on
one CUDA card, per engine configuration.

Run from the root of the repository:  python3 tools/serving_grid_probe.py

Builds ``chip_smoke.py``'s 8B int4 decoder (llama_3_8b, bf16, seed 0,
160 blocks of 64) and, one engine at a time, the smoke's ragged engine
(max batch 8, chunks of 8, prefill chunk 256) as CUDA graphs in five
configurations: plain, ``multi_step=4``, ``SpecConfig(draft_len=3)``,
``SpecConfig(draft_len=8)`` and ``AdapterRegistry(rank=8)``. For each
it runs ``warmup_programs()`` + ``seal_programs()`` and prints one JSON
line: the graphs captured, by family, the seconds, the graph pool's GB
(reserved memory after emptying the cache, before and after), and that
no pool block was claimed. Then the card's name and power limit.
``chip_smoke.py`` captures only the keys its traffic uses in its
multi-step, spec and LoRA phases (a whole grid takes 30 to 130 s an
engine); this is where the whole grids are paid for and measured.
"""
import json
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("serving_grid_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.inference import (AdapterRegistry,
                                            PagedLlamaDecoder,
                                            ServingEngine, SpecConfig)
    from paddle_tpu_torch.models import llama_3_8b
    dec = PagedLlamaDecoder.from_config(
        llama_3_8b(dtype="bfloat16"), seed=0, weight_dtype="int4",
        block_size=64, num_blocks=160, device="cuda")

    def registry():
        reg = AdapterRegistry(rank=8)
        for i in range(4):
            reg.register_random(f"a{i}", seed=200 + i)
        return reg

    configs = {"plain": {}, "multi_step_4": {"multi_step": 4},
               "spec_draft_3": {"spec_decode": SpecConfig(draft_len=3)},
               "spec_draft_8": {"spec_decode": SpecConfig(draft_len=8)},
               "lora_rank_8": {"lora": registry()}}
    for name, kw in configs.items():
        eng = ServingEngine(dec, ragged=True, max_batch_size=8,
                            prefill_chunk=256, chunk_size=8,
                            prompt_buckets=(32, 64, 128, 256, 512, 1024),
                            **kw)
        free0 = dec.cache.free_blocks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup_programs()
        eng.seal_programs()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        torch.cuda.empty_cache()
        by_family = Counter(f for f, _ in eng.programs._graphs)
        print(json.dumps({
            "config": name, "graphs": eng.programs.captured,
            "by_family": dict(by_family), "seconds": secs,
            "pool_gb": (torch.cuda.memory_reserved() - mem0) / 1e9,
            "pool_blocks_untouched": dec.cache.free_blocks == free0}),
            flush=True)
        eng.close()
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
