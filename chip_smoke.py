#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

Run from the root of the repository:  python3 chip_smoke.py
(``--only PHASE[,PHASE...]`` runs env, build and the named phases, which
build what they need, and prints no result.)

Phases, in order; each prints one JSON line with its seconds, and any
failure ends the run with a non-zero exit code and no result:

1. env           torch / CUDA versions and the card's name and power limit.
2. build         compiles ``paddle_tpu_torch/csrc/*.cu`` for sm_90a; the
                 SASS of the nine Hopper flash kernels (forward, dq,
                 dk/dv at head_dim 64, 72 and 128) must hold HGMMA (wgmma)
                 and UTMALDG (TMA load) instructions, and each must have
                 been built with 168 registers a thread (its setmaxnreg
                 split needs them; a launch with fewer raises); the nine
                 bfloat16 decode_matmul instantiations must hold HMMA
                 (mma.sync); the six tensor-core paged-attention kernels
                 (ragged at head_dim 64 / 128 with bf16 and int8 pools,
                 decode at 64 / 128) must hold HMMA and UTMALDG, the two
                 int8 ones UBLKCP (their scale rows). Prints ptxas's
                 registers and spills of every flash, GEMV and
                 paged-attention instantiation (the float32 CUDA-core
                 flash kernels at head_dim 72 must be there, and the
                 Hopper forward at 72 with at least 168 registers and
                 no spills) and the paged kernels' dynamic shared
                 memory.
3. kernels       each kernel against its plain PyTorch version on the card
                 at the shapes its main path gives it (Llama-3-8B serving:
                 ragged attention on the smoke batch with a bf16 and an
                 int8 pool, a W 8 decode ministep at ctx 512, a prefill
                 rung of 8 decode and 128 prefill rows, and d 64 with
                 pages smaller than a stage;
                 dense decode at b 8 and b 4 and at ctx 1..2100 with a
                 ctx-0 row, float32 at d 64, d 256, the int8-pool route
                 and bf16 at d 64 / bs 16; every attention case within 1e-2
                 (1e-4 float32), no NaN, ctx-0 rows exact zeros, two runs
                 bit-identical, with its share of the bound, its plan and,
                 where its rows see one ctx (for a prefill rung: two
                 calls, the decode rows and the prefill rows under an
                 end-aligned causal mask), SDPA's time over the same
                 K/V rows gathered beforehand (not paged); the GEMV at
                 b 1/4/8/32 (int4 on the
                 five projections, int8 and dense on wgu at b 1/8/32,
                 one float32 int4 case on the CUDA-core kernel), each
                 with its share of the bound and its split plan, and
                 the int4/int8 cases slower than torch.matmul listed;
                 flash forward
                 at the dense prefill's b x s of 1 x 256, 4 x 128, 4 x 256
                 and 1 x 512; DiT-XL/2's attention (not causal, b 32 x
                 s 256, 16 / 16 heads of 72) in bf16 within 1e-2 (the
                 Hopper kernels) and float32 within 1e-4 (the CUDA-core
                 kernels), and at d 72 in bf16 within 1e-2 a causal GQA
                 case with ragged edges (sq 300, sk 1000, its dk/dv list
                 cut into pieces), packed documents and a non-causal
                 sq < sk block standing in for the ring's backward;
                 train-moe's attention at hidden 1024 (b 4 x s 2048, 16
                 heads of 64 over 8 kv heads, causal); train-moe-full's
                 at b 2 x s 4096, causal, d 128: DeepSeek-MoE-16B's 16 /
                 16 heads and Qwen2-MoE-A14B's 28 / 4 (group 7);
                 llama_mid training attention, plus a 4096
                 sequence, packed documents and a causal sq < sk case with
                 ragged edges; the ring blocks flash_attention_with_lse and
                 flash_attention_bwd_block at train-mid8k's shard shapes,
                 the backward against a lse merged from two blocks, its
                 dq and dk/dv kernels also timed apart, with the pieces
                 of the dk/dv work list; and serve-model-1b's float32
                 routes at llama_1b's shapes (16 heads, 8 kv heads, d
                 128, pages of 64): ragged W 8 at ctx 512, dense decode b
                 8 at ctx 512, the int4 GEMV of wgu (2048 x 11264) at b 8,
                 flash forward at b 4 x s 256); and a tensor-parallel
                 shard's shapes (serve-tp2-int4): the ragged kernel at W 8
                 ctx 512 with 16 / 4 heads (bf16 and int8 pools) and 8 / 2
                 heads, the int4 GEMV on the five tp-2 shard projections
                 (wqkv 4096 x 3072, wo 2048 x 4096, wgu 4096 x 14336, wd
                 7168 x 4096, head 4096 x 64128) at b 8 and 32; and
                 the GPT family's group 1 (one query head per kv head):
                 ragged W 8 ctx 512 at ERNIE's 20 / 20 heads with a bf16
                 and an int8 pool and a prefill rung of 8 decode and 128
                 prefill rows (its times on the W 8 row), paged
                 decode b 8 ctx 512 at 20 / 20, the int4 GEMV on ERNIE's
                 five products (wqkv 2560 x 7680, wo 2560 x 2560, wi
                 2560 x 12288, wf 12288 x 2560, head 2560 x 103424) at b
                 8 and 32, and flash at gpt_345m's b 8 x s 1024, 16 / 16
                 heads of 64; and one mp-4 rank of train-tp-8b: flash at
                 b 1 x s 4096, 8 / 2 heads of 128 (group 4), causal;
                 with its time, the plain version's time, the time of one
                 PyTorch library call that computes the same function where
                 there is one, and the least time the card could take
                 (bound_ms); for the flash cases also the achieved TFLOP/s,
                 the share of the bound and the ratio to SDPA's time in the
                 same run. Flash backward runs must be bit-identical.
4. train-moe-full  THE FULL-WIDTH MoE PATH: deepseek_moe_16b_like and
                 qwen2_moe_a14b_like (dtype bf16, ragged dispatch,
                 chunked CE 1024, recompute "full"), depth cut, under the
                 DeepSeekMoE recipe with its step counts cut: AdamW(β 0.9
                 / 0.95, weight decay 0.1), LinearWarmup(MultiStepDecay(
                 4.2e-4, [8, 9], 0.316), 4 steps from 0),
                 ClipGradForMOEByGlobalNorm(1.0) over the experts' w1 /
                 w2; b 2 x s 4096 from RandomState(0); eager steps
                 (forward, loss, backward, the clip's expert / dense
                 split, step, clear_grad, the scheduler's step). First
                 DeepSeek at depth 3 with recompute and without, both
                 resident, alternated: first-step losses within 1e-3
                 relative and clip norms within 1e-2, each step's peak.
                 Then each model at the deepest depth whose peak leaves
                 8 GB of the card free (a probe step's peak beside 16 B of
                 training state a parameter; one layer shallower when the
                 warm steps leave less; the run's own free memory at its
                 peak must be >= 8 GB): DeepSeek 2 warm + 10 timed
                 steps, Qwen 2 + 4, each then one traced step. Every loss
                 finite and the last timed below the first; the clip's
                 norm equal to its split's within 1e-3; the flash
                 counters, set to 0 just before and read just after, read
                 2 x depth forwards (forward and recomputation) and depth
                 dq and dk/dv a step, and so does the traced step of
                 flash_wg::*<bf16,128> kernels, no other flash kernel and
                 no serving kernel. Prints each step's loss, lr, clip
                 norm, scale and expert share, the parameter arithmetic,
                 step ms, tokens/s, activated MFU (bench.py's formula),
                 peak and free GB, device ms by family (flash, GEMM,
                 other), the idle share and the clip's passes timed alone.
                 It runs right after kernels, on a card that holds
                 nothing else.
5. tiny-resnet-parity  resnet18 (BasicBlock) and resnext50_32x4d
                 (bottleneck, groups 32), num_classes 10, float32, b 4 x
                 3 x 64 x 64, the same state on the card and the CPU (each
                 residual branch's last BatchNorm gain 0.1): a train-mode
                 forward (logits within 1e-4 of the largest |logit|,
                 running stats within 1e-5), an eval forward (1e-4), three
                 TrainSteps of Momentum(0.01, 0.9) (losses within 1e-4
                 relative, the stats after them within 1e-3), and
                 max_pool2d's output and mask equal on card and CPU on the
                 same stem activations and on the input (ceil mode,
                 per-side padding).
6. train-resnet50  THE RESNET PATH, bench.py's resnet row (bench.py:445-476)
                 at full width and depth: resnet50(num_classes=1000,
                 seed=0) with every parameter cast to bf16 (running stats
                 float32), Momentum(0.1, 0.9) with float32 masters, cross
                 entropy in float32, b 256 x 3 x 224 x 224 bf16 from
                 RandomState(0) in bench.py's order: 2 warm and 10 timed
                 TrainSteps; every loss finite, every running stat moved,
                 no port kernel launched (convolutions are cuDNN's,
                 BatchNorm plain ops). Step ms, imgs/s, MFU (3 x the
                 forward FLOPs counted from the conv and fc shapes, over
                 989 TFLOP/s), peak memory allocated / reserved, device ms
                 by family with the top kernels and the idle share, and
                 Momentum's update alone (device and wall ms, launches).
7. tiny-vision-parity  one constructor of each zoo family at a narrow
                 width (LeNet, AlexNet, vgg11(batch_norm=True),
                 MobileNetV1/V2 at scale 0.25, MobileNetV3-Large at 0.5,
                 SqueezeNet 1.1, DenseNet-121 and InceptionV3 at 128 x
                 128, GoogLeNet, ShuffleNetV2 x0.5), num_classes 10,
                 float32, b 4, the same state on the card and the CPU
                 (every BatchNorm shift 1.0): train-mode and eval logits
                 within 1e-4, running stats within 1e-5, three
                 TrainSteps of Momentum(0.01, 0.9) within 1e-4 relative
                 (a later step's of the first step's loss where it fell
                 below it; InceptionV3's in eval mode); Dropout's rule on
                 the card at p 0.2 / 0.5 over 2^20 values (kept fraction
                 within 4 sigma, kept values x / (1 - p) bit for bit);
                 conv2d's "SAME" at stride 2 and NHWC card against CPU.
8. train-mobilenetv3  THE ZOO PATH: mobilenet_v3_large(num_classes=1000,
                 seed=0) at full width and depth, bf16 parameters
                 (running stats float32), Dropout(0.2) on a card
                 generator, Momentum(0.1, 0.9) with float32 masters, b 256
                 x 3 x 224 x 224 bf16: 2 warm, 10 timed and one traced
                 step; losses finite and falling, every running stat
                 moved, no port kernel launched. Step ms, imgs/s, MFU,
                 peak, idle share, device ms by part with the depthwise
                 convolutions apart from the dense ones, and each part
                 (depthwise and dense convs, BatchNorm, activations, the
                 SE gates) run alone at the step's shapes.
9. train-vision-zoo  every family's ImageNet constructor at full width
                 (LeNet, AlexNet, VGG-16 with and without BatchNorm,
                 MobileNetV1/V2, MobileNetV3-Small, SqueezeNet 1.1,
                 DenseNet-121, GoogLeNet with its aux losses,
                 InceptionV3 at 299 x 299, ShuffleNetV2 x1.0 and swish),
                 b 64 (LeNet b 256 x 1 x 28 x 28), bf16: 1 warm and 2
                 timed steps each; losses finite, running stats moved, no
                 port kernel launched; parameters, step ms, imgs/s, MFU
                 and peak a model.
9a. tiny-tp-train-parity  training's tensor parallelism, card against
                 CPU: llama_tiny and gpt_tiny (hidden 256: head_dim 64,
                 float32, tensor_parallel) at mp 2 on cuda:0 x 2, given
                 the weights of the same model at mp 1 on the CPU by
                 state_dict: logits, loss and every logical gradient
                 within 1e-4 of the largest value; 2 AdamW steps: losses
                 within 1e-5 relative, each weight within 1e-2 of its
                 movement (elements whose grad is 0 but for rounding,
                 such as GPT's k bias, left out and counted); every shard
                 on the card; every flash kernel launched.
9b. train-tp-8b  THE TENSOR-PARALLEL TRAINING PATH: llama_3_8b(dtype=
                 "bfloat16", tensor_parallel=True, sequence_parallel=True)
                 at its published widths, cut to 2 of 32 layers (1.49 B
                 parameters), fleet.init(mp_degree=4) over cuda:0 x 4,
                 b 1 x s 4096, AdamW(3e-4, wd 0.01) with
                 ClipGradByGlobalNorm(1.0) through TrainStep; each q_proj
                 rank holds a [4096, 1024] shard. sequence_parallel is
                 read by nothing in Llama (nor in JAX's), so no
                 sequence-parallel layer runs here. Its first 3 steps
                 beside the same seed's model at mp 1 on the card: losses
                 finite and within 1e-3 relative, step by step, and
                 ClipGradByGlobalNorm's global norms within 1e-4 at step
                 1 (the same weights) and 5e-3 at steps 2-3; 8 launches of
                 each bf16 d-128 flash kernel a step at mp 4 (2 layers x 4
                 ranks, 8 / 2 heads each), 2 at mp 1, no serving kernel;
                 then the two alternated (3 runs of 2 steps each): step
                 ms, tokens/s and MFU (bench.py:258-265 over the cut
                 depth), two traced steps each (device ms by family, the
                 flash kernels' launches, idle share; traced again with
                 more pads while the profiler lost every pad record), the
                 row-parallel sums' device ms measured apart at the
                 step's shapes and counts, peak allocated and reserved.
10. tiny-parity   llama_tiny (float32, int4 weights) served on the card and,
                 with the same weights, on the CPU through the plain
                 versions: the greedy tokens must be equal, and one
                 prefill ministep's logits within 1e-3.
11. tiny-dense-parity  llama_tiny(hidden_size=256) (head_dim 64, int4)
                 through the dense engine (mid chunks, offset finals) and
                 generate() on the card and the CPU: equal greedy tokens,
                 one prefill's logits within 1e-3, and the card ran the
                 paged-decode, flash forward and GEMV kernels. These three
                 tiny phases run the engines' programs as CUDA graphs,
                 captured at first use.
12. tiny-prefix-parity  llama_tiny(hidden_size=256) float32 (int4) with
                 prefix caching, both schedulers: 5 requests, 4 sharing
                 24 tokens; the card with caching on and off and the CPU
                 with it on give equal greedy tokens, the card and the
                 CPU equal hit tokens.
13. tiny-rich-faults-parity JAX's threefry key stream and fault
                 tolerance, card against CPU: the threefry2x32 known
                 answer on the card and the host; the bits and uniforms
                 of an [8, 128256] draw equal on card and CPU, the Gumbel
                 noise within 2e-6; llama_tiny(hidden_size=256) float32
                 (int4) through both engines on the rich mix (greedy;
                 T 0.8 with top_k 40 and top_p 0.9; repetition penalty
                 1.3; a 25% allowed mask; top_k 1 at T 5 and top_p 1e-9
                 at T 3, each beside a greedy twin): the CPU's streams,
                 twins equal, the masked stream inside its mask, every
                 serving kernel launched; and optimistic admission on a
                 14-block pool (preemption with recompute) gives the
                 roomy run's greedy streams on card and CPU.
14. serve-int4   THE MAIN PATH: Llama-3-8B at full width and all 32 layers,
                 int4 weights from a seed, bf16 KV pool, block size 64,
                 served by the ragged engine (8 requests of 100..600 prompt
                 tokens, 32 new tokens each, 6 greedy and 2 at temperature
                 0.8), its programs run eagerly (``cuda_graphs=False``;
                 serve-graphs holds the graphs against these runs), prefix
                 caching on (the engine's default; these prompts share no
                 prefix). The launch counters are set to 0 just before and
                 read just after; a repeat run must give the same tokens;
                 one pure-decode ministep at W=8 must launch exactly 32
                 attention and 129 GEMV kernels; the decode_matmul and
                 attention families' device ms per serving run and per
                 ministep.
15. serve-dense-int4  THE DENSE PATH on the same decoder, eager:
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
                 time beside the ragged ministep of phase 14; generate() at
                 b 4, prompt 256, 32 new tokens; then both engines on the
                 same 8 requests, alternately, 2 runs each, and their
                 decode steps alternately, 2 each (median, min, max);
                 the decode_matmul and attention families' device ms per
                 run and step.
16. serve-prefix-int4  both engines on 8 requests that share a
                 384-token prefix (6 blocks of 64), each with 64..128
                 tokens of its own, 32 new tokens, greedy, caching on
                 against off: 2,688 hit tokens (7 readers x 6 blocks),
                 streams equal or, at the first divergence, a near-tie:
                 the card's logit gap there (one prefill over the
                 context) at most twice the largest difference of those
                 logits from the same ones computed 32 rows at a time;
                 tok/s, TTFT and the prefill's
                 device ms (the same requests with one new token) on and
                 off.
17. serve-graphs  both engines with ``warmup_programs`` +
                 ``seal_programs`` (graphs captured, seconds, pool
                 memory), then serve-dense-int4's requests: tokens equal a
                 fresh eager engine's, stochastic rows included; no
                 unexpected recompile; the launch counters equal what the
                 run's program dispatches call for under the eager gates;
                 the shared-prefix requests equal serve-prefix-int4's with
                 2,688 hit tokens; eager and graph runs alternated, 1 each
                 (tok/s, TTFT, ITL p50 / p99); the
                 idle share of one graph run; a decode chunk (T 8) of 8
                 sequences at ctx 512, eager against graph, alternated 3
                 times (wall ms a step, the graph's device ms and idle
                 share, launches of a chunk). The grid each engine
                 captures holds every key plain and rich, greedy and
                 sampled; the sealed engines serve the next two phases.
18. serve-rich-int4  the rich mix (phase 13's, 32 new tokens, on
                 serve-dense-int4's prompts) through both sealed 8B
                 engines: no unexpected recompile, launches equal what
                 the dispatches call for, streams equal a fresh eager
                 engine's, twins equal, the masked stream inside its
                 mask; tok/s of the rich mix against the plain mix
                 alternated, 3 runs each; a decode chunk (T 8, W / mb 8,
                 ctx 512) greedy, sampled and rich: device ms a step and
                 the sort kernels' share; the widest program the run
                 dispatched plain against rich; the sampler's parts
                 (threefry + Gumbel, sort, plain and rich samplers)
                 timed alone at 8 rows and at that width.
19. serve-faults-int4  both 8B engines with admission="optimistic" on 21
                 free blocks of 64 (the rest held by a placeholder
                 sequence), as sealed graphs: 8 requests of 300..512
                 prompt tokens and 64 new, one of priority 1; clean runs
                 preempt at least 4 times and never the priority-1
                 request, and give the worst-case engine's streams or
                 leave them at a near-tie; then a run with a cancel
                 mid-decode, a 0.02 s deadline and a seeded ChaosMonkey
                 (dispatch and collection faults 0.05, allocator OOMs
                 0.01, no backoff), debug_check after every step: every
                 retry and exhaustion answers an injected fault, every
                 failed request names one, no unexpected recompile, each
                 finished stream the clean one or a near-tie; tok/s
                 optimistic against worst-case, alternated, 1 run each.
20. tiny-ms-spec-lora-parity  llama_tiny float32 with int4 weights on the
                 card (graphs) and the CPU: multi_step=4, spec decode
                 (draft_len 4, n-gram drafter, motif prompts) and a
                 mixed batch over two register_random adapters give
                 equal greedy streams on both; on the card each equals
                 its multi_step=1, spec-off or registry-less engine
                 (base rows); one _lora_delta within 1e-4 of the plain
                 gathered formulation.
21. serve-ms-int4  multi_step=4 (32-ministep windows) on the 8B int4
                 ragged engine as graphs (captured as first used, then
                 sealed) against serve-graphs' multi_step=1 engine,
                 serve-dense-int4's requests: launches, greedy streams
                 equal or a near-tie, windows, capture (graphs, s, pool
                 GB); the two alternated 3 runs each (tok/s, TTFT, ITL)
                 with no recompile; a run's device ms and idle share; a
                 window against a T 8 chunk, device ms a ministep.
22. serve-spec-int4  spec decode at draft_len 3 (<= 32 verify rows: the
                 GEMV) and 8 (72: cuBLAS over the unpacked int4)
                 against spec off on 8 prompts that quote their own
                 text, 64 new: with the n-gram drafter, then oracles of
                 the spec-off streams and of each pass's own streams;
                 acceptance, tokens per verify dispatch, the verify
                 ministep's device ms at both widths, greedy streams
                 equal or a near-tie; draft_len 3 runs warmup_programs +
                 seal_programs before its first request (its whole grid
                 held to no unexpected recompile), draft_len 8 captures
                 as first used, then seals; the three alternated 2 runs
                 each.
23. serve-lora-int4  AdapterRegistry(rank=8) of 4 register_random adapters,
                 8 requests (2 base, 6 over 3 adapters): launches, no
                 recompile, base rows equal the registry-less engine's
                 or a near-tie, hits / misses / evictions per run (each
                 run's prefix-cache clear evicts the parked adapters, so
                 the next run faults them back in), the page gather's
                 and one ministep's deltas' device ms; every module's
                 delta at 8B widths against the plain float32
                 formulation (bf16 within twice a perfect bf16 answer's
                 rounding, float32 within 1e-4 relative); graphs captured
                 as first used, then sealed; tok/s against the base
                 engine, alternated 3 runs each.
24. tiny-fleet-parity  the fleet Router (dp 2, in process, the dense
                 engine, affinity on) on llama_tiny at the fleet tests'
                 geometry with head_dim 64 (hidden 256), float32, the
                 same weights on the card and the CPU: 4 prompts sharing
                 16 tokens, a ChaosMonkey wedge of replica 0 mid-decode;
                 the streams equal a single engine's and card == CPU,
                 routing counters too; the card ran the paged-decode and
                 flash forward kernels.
25. serve-telemetry-int4  serve-graphs' sealed 8B int4 ragged engine on
                 serve-dense-int4's requests three ways, alternated, 3
                 runs each: no telemetry, a Tracer with an SLO monitor
                 (TTFT 2 s, ITL 50 ms at p99), profile_every=8: greedy
                 streams equal across the three, no recompile; tok/s and
                 the tracer's and sampling's costs, records and dropped,
                 the Perfetto export's bytes and seconds (written to
                 chiprun_out/ and read by tools/trace_report.analyze),
                 the attribution p50 of host-schedule, dispatch-queue and
                 device-execute (CUDA events) per program family, and
                 the SLO headroom.
26. fleet-int4   Router(dp=2, transport="inproc") of two ragged 8B int4
                 engines over one weight tree (pools of their own, 160
                 blocks of 64), graphs captured as used: 8 requests, 4
                 sharing the 384-token prefix (3 affinity hits), 32 new
                 (6 greedy); greedy streams equal the one engine's or a
                 near-tie; a ChaosMonkey wedge of replica 1 mid-decode:
                 every victim migrates and finishes, no failed
                 migration, the ms from the wedge to each migrated
                 request's next token, recompute tokens, the graphs the
                 migrations captured; the replica healed through
                 probation; then sealed, dp 2 against one engine
                 alternated, 3 runs each.
27. fleet-proc-int4  the same model and traffic with transport="process":
                 two spawned workers build the 8B decoder from seed 0
                 (module-level _proc_engine_factory, eager engines) and
                 find the kernel library built; greedy streams equal
                 fleet-int4's; inject_kill() SIGKILLs replica 1
                 mid-decode, its requests migrate from the journal, the
                 worker respawns onto probation; spawn and respawn
                 seconds, the step RPC's round trip over the worker's
                 own step, heartbeat misses, exits and restarts.
28. tiny-tp-parity  tensor-parallel serving, card against CPU from one
                 seed: llama_tiny(hidden_size=256, num_key_value_heads=4)
                 float32 with int4 weights; the ragged engine at tp 1, 2
                 and 4 (every shard on cuda:0, or on the CPU; graphs
                 captured as used), the tp-2 decoder's generate() and
                 Router(dp=2, tp=2) over ["cuda:0"] * 4 with a
                 ChaosMonkey wedge of replica 0 mid-decode: greedy
                 streams equal tp 1's (the Router's equal one engine's)
                 on each device; card == CPU, routing counters too, or,
                 where the tp-1 engines part, a near-tie (the CPU's
                 logit gap within twice the card / CPU logit
                 difference); every kernel of each path launched.
29. serve-tp2-int4  Llama-3-8B int4 at tp 2 with both shards on cuda:0
                 (ServingEngine(dec, tp=2) over a decoder on
                 ProcessMesh(devices=["cuda:0"] * 2), seed 0: serve-int4's
                 weights cut by the placement table), bf16 pool of 160
                 blocks of 64, serve-int4's 8 requests; fp32 and int8
                 comm, each eager and then as graphs captured as used
                 and sealed: launches exactly what the dispatches call
                 for at two shards (64 ragged and 258 GEMV a W 8
                 ministep), graphs == eager on every row, no recompile
                 after the seal, fp32 greedy streams equal the sealed
                 tp-1 engine's or a near-tie; int8 comm on one prefill:
                 the argmax equal to fp32 comm's and each of its 64
                 collectives within the reference's per-call bound of
                 its exact sum (tests/test_tp_serving.py:150), the
                 logits' relative difference reported, not held (its
                 streams reported too); tok/s, TTFT and ITL of tp 1
                 / tp 2 fp32 / tp 2 int8 alternated, 3 runs each; a T 8
                 chunk's device ms at W 8 ctx 512; pool bytes a shard;
                 then eager legs for the other shard shapes: tp 2 with
                 an int8 pool and tp 4 (8 / 2 heads a shard; greedy
                 streams against tp 1's near-tie rule), each with its
                 exact launches.
30. serve-bf16-kv8  the same model with bf16 weights and an int8 KV pool
                 (4 requests): the int8 branch of the attention kernel on
                 the serving path; one W 8 ministep launches exactly 32
                 attention kernels; the attention family's device ms per
                 run and per ministep.
31. tiny-train-parity  llama_tiny(hidden_size=256) in float32 (head_dim 64)
                 with the same weights on the card and the CPU: 3 TrainSteps
                 of AdamW(1e-3) give losses within 1e-4 relative, and the
                 card ran all three flash kernels.
32. tiny-ring-parity  llama_tiny(hidden_size=256, sep_degree=4) in
                 float32 (head_dim 64) at b 2 x s 256 under a sep-4 fleet
                 mesh, the same weights on the card (["cuda:0"] * 4) and on
                 the CPU (["cpu"] * 4): 3 TrainSteps of AdamW(1e-3) give
                 losses within 1e-4 relative, the card's equal the same
                 model's at sep_degree=1 within 1e-4, and the flash counters
                 read exactly what the ring calls for (2 layers x 4 ranks
                 x 6 blocks per step of each kernel).
33. tiny-model-parity  LlamaForCausalLM whole: llama_tiny(hidden_size=256,
                 tie_word_embeddings=True, use_recompute=True,
                 recompute_granularity="full_attn") in float32 with the
                 same weights on the card and the CPU (the tied table
                 scaled by 0.05: at N(0, 1) every stream repeats its last
                 prompt token): 2 TrainSteps of
                 AdamW(1e-3) give losses within 1e-4 relative and the card
                 launches 4 flash forwards a layer (2 a step: forward and
                 recomputed forward) and 2 dq and dk/dv; then
                 model.generate greedy and seeded at temperature 0.8 and
                 beam search with 3 beams, and ServingEngine(model,
                 weight_dtype="int4") on both schedulers: tokens equal on
                 card and CPU, every kernel of each engine launched.
34. train-mid    THE TRAINING PATH: llama_mid (0.65B) at full width and all
                 11 layers, bf16 compute, seed 0, batch 4 x seq 2048 (ids as
                 bench.py makes them), AdamW(1e-4, weight_decay=0.01): 2 warm
                 and 10 timed TrainSteps. The flash counters are set to 0
                 just before and read just after: exactly 11 forward, 11 dq
                 and 11 dk/dv launches per step; every loss finite and the
                 last below the first. Step ms, tokens/s, MFU by bench.py's
                 formula against 989 TFLOP/s, peak memory, device time by
                 kernel family and the idle share.
35. train-mid8k  THE LONG-CONTEXT PATH: llama_mid(dtype="bfloat16",
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
36. train-1b     bench.py's 1b row: llama_1b(dtype="bfloat16",
                 use_recompute=True, recompute_granularity="full_attn",
                 chunked_ce_tokens=1024), all 18 layers, b 4 x s 2048,
                 AdamW(1e-4, weight_decay=0.01, moment_dtype="bfloat16"):
                 2 warm and 10 timed steps; the flash counters must read
                 36 forward (18 and 18 recomputed), 18 dq and 18 dk/dv a
                 step; every loss finite, the last below the first. Step
                 ms, tokens/s, MFU (bench.py's formula over 989 TFLOP/s),
                 peak memory, device time by family; then the same row
                 without recompute from the same seed (its first loss
                 within 1e-3 of the recompute model's, 18 of each flash
                 kernel a step) and the two alternated, 3 runs of 2 steps
                 each: step ms, MFU and peak memory of each.
37. serve-model-1b  the model train-1b trained, served by
                 ServingEngine(model, weight_dtype="int4", block_size=64,
                 num_blocks=160) on both schedulers: float32 activations
                 and pool (the embedding's dtype, as in JAX), so every
                 serving kernel takes its float32 route. serve-dense-int4's
                 request lengths, 32 new (6 greedy, 2 at 0.8); graphs
                 captured as first used, then sealed; the sealed run's
                 launches equal what its dispatches call for (18 attention
                 and 73 GEMV a decode step), no recompile, greedy streams
                 equal the capturing run's, the pool's bytes exact. tok/s,
                 TTFT p50 / p99, latency p50 / p99, queue wait p50, ITL,
                 pool bytes and bytes a token, a decode step's launches,
                 wall and device ms, and the kernel routes the profiler
                 saw (CUDA-core only). Then the weight_dtype=None engine
                 (float32 products, eager) against the model's own
                 generate() (bf16 activations) on two greedy prompts:
                 equal, or parted where the float32 logit gap is at most
                 twice the difference between the two computations'
                 logits there.
38. tiny-gpt-parity  gpt_tiny(hidden_size=256) (head_dim 64, as many kv
                 heads as heads) float32 with int4 weights, the same
                 weights on the card (graphs) and the CPU: both engines'
                 greedy streams and generate() equal, one prefill's
                 logits within 1e-3, and the card ran the ragged,
                 paged-decode, flash forward and GEMV kernels.
39. serve-ernie-int4  THE GPT PATH: ernie_45_dense_3b at full width and
                 all 28 layers (20 heads = 20 kv heads, d 128, vocab
                 103,424), int4 weights from PagedGPTDecoder.from_config(
                 seed=0), bf16 activations and pool (160 blocks of 64);
                 the ragged and the dense engine as CUDA graphs (keys
                 captured as the first run uses them, then sealed): 8
                 greedy requests of 64..512 prompt tokens, 64 new. The
                 sealed run's launches equal what its dispatches call
                 for (the counters set to 0 just before, read just
                 after), its tokens the capturing run's, no recompile;
                 the schedulers' streams equal or a near-tie; tok/s,
                 TTFT, ITL, capture seconds and pool GB; a W 8 ministep
                 (28 ragged + 113 GEMV launches) and a dense decode step
                 (28 paged-decode + 113 GEMV) at ctx 512 with their
                 device ms beside the 0.76 ms byte bound; an eager leg
                 on an int8 pool over the same weights (reported), its
                 GEMV launches counted by weight at the launch site
                 (the kernels line's ERNIE GEMV rows).
40. train-gpt-345m  gpt_345m in bf16 (float32 weights, tied head), b 8 x
                 s 1024, AdamW(1e-4, weight_decay=0.01): 1 warm and 5
                 timed TrainSteps, exactly 24 of each flash kernel a
                 step, every loss finite and the last below the first;
                 step ms, tokens/s, MFU, peak memory, device time.
41. tiny-dit-parity  DiT at head_dim 72 (hidden 144, 2 heads, depth 2)
                 and 64 (hidden 128, 2 heads), every parameter drawn
                 from a seed (normal x 0.02, so adaLN-Zero does not make
                 the output 0), the same weights on the card and the
                 CPU, float32 and bf16: outputs within 1e-3 / 1e-2 of the
                 largest |out|, three TrainSteps of AdamW(1e-3) (label
                 dropout off) with losses within 1e-3 / 1e-2 relative
                 (a bf16 loss is itself rounded to 8 bits); each card
                 run launches exactly depth forward, dq and dk/dv flash
                 kernels a step and depth forwards an eval forward.
42. train-dit-xl2  THE DiT PATH, bench.py's dit row: DiT(dit_xl_2(
                 dtype="bfloat16", learn_sigma=False)), all 28 layers
                 (675 M parameters), b 32 on [32, 4, 32, 32] latents
                 with timesteps and labels from RandomState(0) as
                 bench.py draws them, label dropout 0.1 from a seeded
                 generator, AdamW(1e-4), F.mse_loss to the noise: 2 warm
                 and 8 timed TrainSteps. The flash counters, set to 0
                 just before and read just after, must read exactly 28
                 forward, 28 dq and 28 dk/dv launches a step (d 72: the
                 Hopper kernels, the forward read off the profile's
                 kernel names), no serving kernel; every loss
                 finite and the last below the first. Step ms, imgs/s,
                 MFU by bench.py's formula (6 N T + 12 depth hidden T^2
                 a picture over 989 TFLOP/s), peak memory, device ms by
                 family (flash, GEMM, conv, other) and the idle share,
                 beside the card's name and power limit.
43. tiny-moe-parity  moe_tiny(hidden_size=256, 4 / 2 heads: head_dim 64)
                 with the same numpy state on the card and the CPU, dense
                 and ragged dispatch: float32 logits within 1e-4 of the
                 largest |logit| and five TrainSteps of AdamW(1e-3) with
                 losses within 1e-5 relative (the ragged route's grouped
                 product on the card: torch._grouped_mm in float32);
                 bf16: the share of tokens whose top-k experts agree
                 between card and CPU, those tokens' logits within 1e-2
                 of the largest |logit| (the MoE layer is the last, so a
                 token's routing reaches only its own logits), and the
                 MoE layer's forward and backward under CUDA sync
                 debugging set to raise (no host sync: for ragged the
                 grouped route, torch._grouped_mm); exact flash
                 launches.
44. train-moe    THE MoE PATH, bench.py's four moe rows as it builds them
                 (bench.py:278-318, :409-431): MoEConfig(dtype="bfloat16",
                 8 layers, 16 / 8 heads, top-2, one shared expert, chunked
                 CE 1024) at hidden 1024 with 8 experts of 1408 (dense and
                 ragged dispatch) and 64 of 512 (ragged), and at hidden
                 2048 with 8 of 2048 (ragged, bf16 AdamW moments); b 4 x
                 s 2048, AdamW(1e-4, weight_decay=0.01), 2 warm and 8
                 timed TrainSteps each. First the grouped product
                 (torch._grouped_mm, bf16) at each row's expert geometry,
                 16,384 routed rows with one empty expert: the product
                 and its autograd dX and dW within 1e-2 of the largest
                 |reference| of a float32 matmul per expert. The flash
                 counters, set to 0 just before and read just after, must
                 read 8 of each kernel a step, and a traced step must
                 hold 8 launches of each of the three Hopper kernels at
                 head_dim 64 (128 for the wide row) and no other flash
                 kernel; every loss finite, the last below the first. Step ms, tokens/s,
                 activated MFU (bench.py's formula over 989 TFLOP/s),
                 total and activated parameters, peak memory, device ms
                 by family and the idle share; the dense row's dropped
                 fraction from one eager forward.
45. capture-failure  a program with a host sync inside: its first
                 dispatch raises, no graph is kept and it is not run
                 eagerly in its place (last, as a failed capture may
                 leave the allocator's pool unusable).

Each phase line carries its seconds and profile_s, the part of them its
profiler traces took (device activity only; each trace opens with one-
cycle pad kernels that take the records a long-lived process's session
loses first, reported as pad_records_lost, None where all were lost).
Then a {"kernels": [...]} line, the card's name and power limit as
nvidia-smi reports them, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Bounds use the H100 SXM data sheet: 3.35 TB/s of device memory and
989 TFLOP/s dense bf16 on the tensor cores.
Serving and training leave each other's counters alone: each path resets
and reads only its own kernels' counters.
"""
import copy
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
# the BatchNorm shift tiny-vision-parity gives every BatchNorm, as
# tests/test_torch_vision_zoo.py does (BN_SHIFT there)
ZOO_BN_SHIFT = 1.0
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
SHAPES_8B = {"wqkv": (4096, 6144), "wo": (4096, 4096),
             "wgu": (4096, 28672), "wd": (14336, 4096),
             "head": (4096, 128256)}
# a tp-2 shard's int4 products at 8B (serve-tp2-int4): column shards
# halve N (q/k/v of 16 / 4 / 4 heads, gate/up, the head's vocab half),
# row shards halve K (wo, wd)
SHAPES_8B_TP2 = {"wqkv_tp2": (4096, 3072), "wo_tp2": (2048, 4096),
                 "wgu_tp2": (4096, 14336), "wd_tp2": (7168, 4096),
                 "head_tp2": (4096, 64128)}
# ernie_45_dense_3b's int4 products (serve-ernie-int4): the fused q/k/v
# of 20 heads of 128, the output projection, the GELU MLP's fc_in and
# fc_out and the untied head over a 103,424 vocabulary (the widest N the
# GEMV takes)
SHAPES_ERNIE = {"ernie_wqkv": (2560, 7680), "ernie_wo": (2560, 2560),
                "ernie_wi": (2560, 12288), "ernie_wf": (12288, 2560),
                "ernie_head": (2560, 103424)}
# every GEMV case's [K, N]: the 8B projections whole and at a tp-2
# shard, llama_1b's gate/up (serve-model-1b's widest product, float32
# x) and ERNIE's
GEMV_SHAPES = dict(SHAPES_8B, **SHAPES_8B_TP2, **{"1b_wgu": (2048, 11264)},
                   **SHAPES_ERNIE)
# flash attention cases (all causal, bf16 unless named): the llama_mid
# training shape first; `docs` packed documents plus a padded tail. bf16
# at d 64/72/128 runs the Hopper (wgmma, TMA) kernels, float32 and d 256 the
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
    dict(name="f32_1b_b4_s256", b=4, sq=256, sk=256, h=16, hk=8, d=128,
         dtype="float32"),
    dict(name="d256", b=1, sq=300, sk=300, h=4, hk=1, d=256),
    # train-gpt-345m's attention: multi-head (one query head per kv
    # head), b 8 x s 1024, 16 heads of 64
    dict(name="gpt_345m", b=8, sq=1024, sk=1024, h=16, hk=16, d=64),
    # train-dit-xl2's attention: not causal, b 32 x s 256 (16 x 16
    # patches), 16 heads of 72 (DiT-XL/2's 1152 / 16): bf16 (the Hopper
    # kernels) and float32 (the CUDA-core kernels)
    dict(name="dit_xl2", b=32, sq=256, sk=256, h=16, hk=16, d=72,
         causal=False, tol=1e-2),
    dict(name="f32_dit_xl2", b=32, sq=256, sk=256, h=16, hk=16, d=72,
         causal=False, tol=1e-4, dtype="float32"),
    # the d-72 Hopper kernels off DiT's shape: causal GQA with ragged
    # edges (its dk/dv list, 32 rows, is cut into pieces), packed
    # documents, and a non-causal sq < sk block as the ring's backward
    # block gives it
    dict(name="d72_sq300_sk1000", b=2, sq=300, sk=1000, h=8, hk=2, d=72,
         tol=1e-2),
    dict(name="d72_packed", b=1, sq=2048, sk=2048, h=16, hk=8, d=72,
         docs=4, tol=1e-2),
    dict(name="d72_block_sq1024_sk2048", b=1, sq=1024, sk=2048, h=16,
         hk=16, d=72, causal=False, tol=1e-2),
    # train-moe's attention at hidden 1024: b 4 x s 2048, 16 heads of 64
    # over 8 kv heads, causal (its wide row, d 128, is llama_mid's case)
    dict(name="moe_d64", b=4, sq=2048, sk=2048, h=16, hk=8, d=64),
    # train-moe-full's attention, b 2 x s 4096, causal, d 128: DeepSeek-
    # MoE-16B's 16 / 16 heads and Qwen2-MoE-A14B's 28 / 4 (group 7)
    dict(name="deepseek_moe_16b", b=2, sq=4096, sk=4096, h=16, hk=16,
         d=128),
    dict(name="qwen2_moe_a14b", b=2, sq=4096, sk=4096, h=28, hk=4, d=128),
    # train-tp-8b's attention: one mp-4 rank of Llama-3-8B (its 32 / 8
    # heads cut to 8 / 2, group 4), b 1 x s 4096, causal, d 128
    dict(name="tp4_8b", b=1, sq=4096, sk=4096, h=8, hk=2, d=128),
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


def _clean_run(st, where):
    """A run without injected faults: no retry and no failed request.
    The engine absorbs an exception of a dispatch into failed requests,
    so a CUDA error would otherwise pass as a short stream."""
    _require(st["retries"] == 0 and st["failed"] == 0
             and st["dispatch_exhaustions"] == 0,
             f"{where}: {st['retries']} retries, {st['failed']} failed "
             f"requests, {st['dispatch_exhaustions']} exhausted dispatches "
             f"without fault injection")


def _emit(obj):
    print(json.dumps(obj), flush=True)


# phases named by --only (None: every phase)
_ONLY = None


# seconds spent inside _device_breakdown (the profiler and its trace),
# reported per phase as profile_s
_PROFILE_S = [0.0]


def _phase(name, fn):
    if _ONLY is not None and name not in _ONLY | {"env", "build"}:
        return None
    t0 = time.perf_counter()
    _PROFILE_S[0] = 0.0
    info = fn()
    _emit(dict(phase=name, seconds=round(time.perf_counter() - t0, 3),
               profile_s=round(_PROFILE_S[0], 3), **info))
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


# one-cycle spin kernels that open every profiler session. In a process
# that has run many phases, a session loses the device records of its
# first kernel launches (48 at train-moe, their runtime records kept and
# their outputs right: tools/flash_trace_probe.py --before smoke; 57 to
# more than 512 in a whole smoke); a fresh process loses none. The pads
# take that loss in place of fn's kernels.
_PAD_LAUNCHES = 4096


def _kernel_events(torch, fn, pads=_PAD_LAUNCHES):
    """({kernel name: [launches, device us]} of what fn ran on the card,
    pad records lost) (torch.profiler, device activity only). The session
    opens with ``pads`` spin kernels, left out of the result; the records
    lost are the session's first, so fn's are whole when a pad was
    recorded, and the count lost is None (fn's may be short) when none
    was. Read off the raw Kineto events: key_averages() first builds a
    Python object for every event, which took most of a serving phase's
    profile time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pads):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out, kept = {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if "spin_kernel" in ev.name():
                kept += 1
                continue
            n = out.setdefault(ev.name(), [0, 0.0])
            n[0] += 1
            n[1] += ev.duration_ns() / 1e3
    return out, (pads - kept if kept else None)


def _family(name):
    """The kernel family of a kernel name, as _device_breakdown sums."""
    low = name.lower()
    if re.search(r"tc::tc_kernel|cc::cc_kernel|splitk_reduce_kernel", name):
        return "decode_matmul"
    if re.search(r"ragged_attention_(cc_)?kernel", name):
        return "ragged_paged_attention"
    if re.search(r"paged_decode_(cc_)?kernel", name):
        return "paged_attention_decode"
    # flash_wg's names demangled (flash_wg::...) or not (8flash_wg...)
    if re.search(r"flash_fwd_kernel|flash_wg.*fwd_kernel", name):
        return "flash_fwd"
    if re.search(r"flash_bwd_|flash_wg.*(d(q|kv)_kernel|dkv_piece_sum)",
                 name):
        return "flash_bwd"
    if re.search(r"conv|fprop|dgrad|wgrad", low):
        return "conv"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "cutlass")):
        return "library_gemm"
    if "sort" in low:
        return "sort"
    return "other"


def _flash_kernel_name(name):
    """A flash kernel's instantiation from its profiler name (demangled
    or not):
    flash_wg::fwd_kernel<bf16,72> (Hopper) or flash_fwd_kernel<f32,72>
    (CUDA cores); the name's head otherwise."""
    wg = re.search(r"flash_wg.*?(fwd|dq|dkv)_kernel(?:<|ILi)(\d+)", name)
    if wg:
        return f"flash_wg::{wg.group(1)}_kernel<bf16,{wg.group(2)}>"
    cc = re.search(r"(flash_\w+_kernel)<(float|__nv_bfloat16), (\d+)>", name)
    if cc:
        dt = "f32" if cc.group(2) == "float" else "bf16"
        return f"{cc.group(1)}<{dt},{cc.group(3)}>"
    return name[:60]


def _device_breakdown(torch, fn, wall_ms, pads=_PAD_LAUNCHES):
    """Device time of fn by kernel family (torch.profiler), launches
    and ms of each flash instantiation, and the idle share of
    ``wall_ms``, the wall time of the same work measured without the
    profiler (which slows the host several fold). Reports what the
    profiler saw, and the pad records lost (None: all, so fn's trace may
    be short); an empty trace leaves the families empty rather than
    failing."""
    t0 = time.perf_counter()
    fams, other, flash, kernels = {}, {}, {}, 0
    events, lost = _kernel_events(torch, fn, pads)
    for name, (count, us) in events.items():
        kernels += count
        fam = _family(name)
        if fam == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + us / 1e3
        elif fam.startswith("flash"):
            n = flash.setdefault(_flash_kernel_name(name), [0, 0.0])
            n[0] += count
            n[1] += us / 1e3
        fams[fam] = fams.get(fam, 0.0) + us / 1e3
    busy = sum(fams.values())
    _PROFILE_S[0] += time.perf_counter() - t0
    return {"device_ms_by_family": fams, "device_ms": busy,
            "device_kernels": kernels, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if busy else None,
            "flash_kernels": flash, "pads": pads,
            "pad_records_lost": lost,
            "top_other": dict(sorted(other.items(),
                                     key=lambda kv: -kv[1])[:6])}


# the port's kernels by route, from their names in a profile: float32
# operands take the CUDA-core kernels (flash: flash_attention.cu), bf16
# ones the tensor-core kernels (flash: the wgmma kernels)
_ROUTES = (("ragged_paged_attention cuda-core", r"ragged_attention_cc_kernel"),
           ("ragged_paged_attention tensor-core", r"ragged_attention_kernel"),
           ("paged_attention_decode cuda-core", r"paged_decode_cc_kernel"),
           ("paged_attention_decode tensor-core", r"paged_decode_kernel"),
           ("decode_matmul cuda-core", r"cc::cc_kernel"),
           ("decode_matmul tensor-core", r"tc::tc_kernel"),
           ("flash_fwd cuda-core", r"flash_fwd_kernel"),
           ("flash_fwd wgmma", r"flash_wg::.*fwd_kernel"))


def _routes(torch, fn):
    """Launches of each kernel route of the port in fn, read off the
    kernel names torch.profiler records."""
    t0 = time.perf_counter()
    out = {}
    for name, (count, _us) in _kernel_events(torch, fn)[0].items():
        for route, pat in _ROUTES:
            if re.search(pat, name):
                out[route] = out.get(route, 0) + count
                break
    _PROFILE_S[0] += time.perf_counter() - t0
    return out


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


def _flash_wg_kernels(cfa):
    """The Hopper flash instantiations the wrappers route to, by name."""
    return {f"flash_wg::{kern}_kernel<bf16,{d}>": (kern, d)
            for kern, dims in cfa.HOPPER_HEAD_DIMS.items() for d in dims}


def _flash_sass(sass, cfa):
    """Count HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    Hopper flash kernel of the built library; fails unless every one the
    wrappers route to (fwd, dq and dk/dv at head_dim 64, 72 and 128) is
    there with both, and no other."""
    found = _count_sass(sass, _flash_wg_name, ("HGMMA", "UTMALDG"))
    _require(set(found) == set(_flash_wg_kernels(cfa))
             and all(min(c.values()) > 0 for c in found.values()),
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
                  dtype="bfloat16", causal=True):
    """q, k, v, dout of dtype and, with docs, int32 segment ids: `docs`
    documents of random lengths and a padded tail of sq // 16 tokens (q
    ids -1, kv ids -2, so the tail sees nothing). Also the visible
    (query, key) pairs per head under the mask (causal or not), from
    these ids."""
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev) \
            .to(getattr(torch, dtype))

    q, k, v, dout = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d), \
        rnd(b, sq, h, d)
    qs = ks = None
    vis = (torch.arange(sq, device=dev)[:, None] + (sk - sq)
           >= torch.arange(sk, device=dev)[None, :])[None]
    if not causal:
        vis = torch.ones_like(vis)
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
    """decode_matmul on one projection (GEMV_SHAPES[name]) at b
    activation rows against decode_matmul_reference: kind "int4_halves",
    "int8" or "dense" with bf16 x, or "int4_halves_f32" (float32 x, the
    CUDA-core kernel). Raises unless the relative max error is below
    2e-2; returns the errors, the kernel's time (L2 flushed), the plain
    version's, torch.matmul's on the weight dequantized and scaled ahead
    of time in x's dtype (the library yardstick), the byte bound and the
    share of it reached, and the split plan."""
    from paddle_tpu_torch.ops.qweight import QWeight
    K, N = GEMV_SHAPES[name]
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
    if dtype == "bfloat16" and d in cfa.HOPPER_HEAD_DIMS["dkv"]:
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
                      d=128, bs=64, max_pages=128, dtype="bfloat16",
                      quantized=False):
    """A ragged batch in the engine's layout at the 8B attention shapes:
    one decode row per sequence at decode_ctx, then, with prefill =
    (rows, offset), that many prefill rows of one more sequence at
    offsets offset .. offset + rows - 1 (row_ctx offset + 1 ..). Every
    sequence's visible pages distinct, the rest of its table pointing
    anywhere. Also the bytes the function must move (q and out once,
    each sequence's visible K/V rows of each kv-head once, the table
    entries they take, row_seq / row_ctx) and its flops. ``quantized``:
    an int8 pool with float32 scales per (slot, kv-head)."""
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
    dt = getattr(torch, dtype)
    q = torch.randn((rows, nh, d), generator=gen, device=dev).to(dt)

    def plane():
        if quantized:
            return (torch.randint(-127, 128, (nb, kvh, bs, d), generator=gen,
                                  device=dev).to(torch.int8),
                    (torch.rand((nb, kvh, bs), generator=gen, device=dev)
                     * 0.05 + 0.001))
        return torch.randn((nb, kvh, bs, d), generator=gen,
                           device=dev).to(dt)

    k, v = plane(), plane()
    esz = q.element_size()
    per_pos = kvh * (d + 4) if quantized else kvh * d * esz
    nbytes = 2 * q.numel() * esz + 2 * sum(seq_ctx) * per_pos \
        + 4 * sum(need) + 8 * rows
    flops = 4 * nh * d * sum(row_ctx)
    args = (q, k, v, tables,
            torch.tensor(row_seq, dtype=torch.int32, device=dev),
            torch.tensor(row_ctx, dtype=torch.int32, device=dev))
    return args, nbytes, flops


def _gathered(q, pools, tables, ctx):
    """The K/V rows that sequences tables[0..n) see at ctx positions each,
    gathered from pages into contiguous [n, kv_heads, ctx, d] in q's
    dtype (an int8 pool dequantized)."""
    out = []
    for pool in pools:
        if isinstance(pool, tuple):
            pool = (pool[0].float() * pool[1][..., None]).to(q.dtype)
        _, kvh, bs, d = pool.shape
        x = pool[tables[:, :-(-ctx // bs)].long()]  # [n, pages, kvh, bs, d]
        out.append(x.permute(0, 2, 1, 3, 4).reshape(
            x.shape[0], kvh, -1, d)[:, :, :ctx].contiguous())
    return out


def _sdpa_ms(torch, timer, q, k, v, tables, ctx):
    """The yardstick of a case whose rows are one sequence each and all
    see ctx positions: torch's scaled_dot_product_attention over the same
    K/V rows gathered beforehand into contiguous [b, kv_heads, ctx, d]
    (enable_gqa); an int8 pool dequantized beforehand too. Not paged, so
    not the same function: the port never calls it."""
    import torch.nn.functional as F
    kc, vc = _gathered(q, (k, v), tables[:q.shape[0]], ctx)
    qq = q[:, :, None, :].contiguous()
    return timer(lambda: F.scaled_dot_product_attention(
        qq, kc, vc, enable_gqa=True), iters=20)


def _sdpa_rung_ms(torch, timer, q, k, v, tables, ctx, prefill):
    """The yardstick of a prefill rung (_ragged_rows_case: one decode row
    per sequence at ctx, then `rows` prefill rows of one more sequence at
    offsets offset ..): two SDPA calls over the K/V rows gathered
    beforehand, the decode rows as _sdpa_ms runs them and the prefill
    rows against their sequence's offset + rows positions under a causal
    mask aligned to its end. Not paged, so not the same function: the
    port never calls it."""
    import torch.nn.functional as F
    rows, offset = prefill
    n_dec = q.shape[0] - rows
    kd, vd = _gathered(q, (k, v), tables[:n_dec], ctx)
    kp, vp = _gathered(q, (k, v), tables[n_dec:n_dec + 1], offset + rows)
    qd = q[:n_dec, :, None, :].contiguous()
    qp = q[n_dec:].transpose(0, 1)[None].contiguous()  # [1, nh, rows, d]
    mask = (torch.arange(offset + rows, device=q.device)[None, :]
            <= offset + torch.arange(rows, device=q.device)[:, None])

    def both():
        F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)
        F.scaled_dot_product_attention(qp, kp, vp, attn_mask=mask,
                                       enable_gqa=True)

    return timer(both, iters=20)


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
    # serve-model-1b's float32 decode ministep (llama_1b: 16 heads, 8 kv
    # heads, d 128, pages of 64): the CUDA-core kernel
    dict(name="f32_1b_w8_ctx512", decode=[512] * 8,
         geom=dict(nh=16, kvh=8, dtype="float32")),
    # serve-tp2-int4's decode ministep at a shard's heads: the 8B at tp 2
    # holds 16 query / 4 kv heads a shard (bf16 and int8 pools), at tp 4
    # 8 / 2
    dict(name="tp2_w8_ctx512", decode=[512] * 8, geom=dict(nh=16, kvh=4)),
    dict(name="tp2_int8_w8_ctx512", decode=[512] * 8, quantized=True,
         geom=dict(nh=16, kvh=4)),
    dict(name="tp4_w8_ctx512", decode=[512] * 8, geom=dict(nh=8, kvh=2)),
    # serve-ernie-int4's attention at group 1 (ernie_45_dense_3b: 20
    # heads, 20 kv heads, d 128, pages of 64): the W 8 decode ministep
    # at ctx 512 with a bf16 and an int8 pool, and the prefill rung of 8
    # decode and 128 prefill rows
    dict(name="ernie_w8_ctx512", decode=[512] * 8, geom=dict(nh=20, kvh=20)),
    dict(name="ernie_int8_w8_ctx512", decode=[512] * 8, quantized=True,
         geom=dict(nh=20, kvh=20)),
    dict(name="ernie_prefill_128", decode=[512] * 8, prefill=(128, 384),
         geom=dict(nh=20, kvh=20)),
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
    f32 = spec.get("geom", {}).get("dtype") == "float32"
    if "decode" in spec:
        args, nbytes, flops = _ragged_rows_case(torch, gen, spec["decode"],
                                                spec.get("prefill"),
                                                quantized=quantized,
                                                **spec.get("geom", {}))
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
    tol = 1e-4 if f32 else 1e-2
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
            "pool": "int8" if quantized else ("float32" if f32 else "bf16"),
            "rows": int(q.shape[0]), "tolerance": tol, "max_abs_err": err,
            "zero_rows": int(pad.sum()),
            "plan": _attention_plan(torch, q, pool, args[3]),
            "ms": timer(kern, iters=20),
            "plain_ms": timer(
                lambda: pa.ragged_paged_attention_reference(*args),
                iters=3),
            "library_ms": None}
    case["bound_ms"], case["bound_by"] = _bound(
        nbytes, flops, F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    ctx = spec.get("decode", [])
    if ctx and len(set(ctx)) == 1 and "prefill" not in spec:
        case["library_ms"] = _sdpa_ms(torch, timer, q, k, args[2], args[3],
                                      ctx[0])
        case["library_note"] = ("not paged: SDPA over the same K/V rows "
                                "gathered beforehand")
    elif ctx and len(set(ctx)) == 1:
        case["library_ms"] = _sdpa_rung_ms(torch, timer, q, k, args[2],
                                           args[3], ctx[0], spec["prefill"])
        case["library_note"] = ("not paged: two SDPA calls over the same "
                                "K/V rows gathered beforehand, the decode "
                                "rows and the prefill rows under an "
                                "end-aligned causal mask")
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
    # serve-model-1b's float32 dense decode step (llama_1b, pages of 64)
    dict(name="f32_1b_b8_ctx512", ctx=[512] * 8, nh=16, kvh=8,
         dtype="float32"),
    # serve-ernie-int4's dense decode step at group 1 (20 / 20 heads)
    dict(name="ernie_b8_ctx512", ctx=[512] * 8, nh=20, kvh=20),
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


def _proc_engine_factory(replica_idx, devices):
    """fleet-proc-int4's engine, built in a spawned worker: the kernel
    library loaded first (noting whether this process found it built),
    then the 8B int4 decoder from seed 0 on the card (the same weights in
    every worker) and an eager ragged engine over it. The notes go to
    chiprun_out/fleet_proc_worker_<pid>.json."""
    from paddle_tpu_torch.inference import PagedLlamaDecoder, ServingEngine
    from paddle_tpu_torch.models import llama_3_8b
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.load_library()
    note = {"replica": replica_idx, "pid": os.getpid(),
            "library_built_here": _build.build_info["built"],
            "library_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    dec = PagedLlamaDecoder.from_config(
        llama_3_8b(dtype="bfloat16"), seed=0, weight_dtype="int4",
        block_size=64, num_blocks=160, device="cuda")
    note["decoder_s"] = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/fleet_proc_worker_{os.getpid()}.json", "w") as f:
        json.dump(note, f)
    return ServingEngine(dec, ragged=True, max_batch_size=8,
                         prefill_chunk=256, chunk_size=8,
                         prompt_buckets=(32, 64, 128, 256, 512, 1024),
                         cuda_graphs=False)


def _conv_fc_flops(torch, model, size):
    """Forward FLOPs of one picture of size x size through ``model``: 2 x
    the multiply-adds of every Conv2D and Linear, from the shapes a
    forward at batch 1 gives them (eval mode, so the running stats stay
    and GoogLeNet's aux heads do not run), with as many input channels
    as the model's first Conv2D takes (LeNet's 1)."""
    total = [0]
    first = next(m for m in model.modules()
                 if type(m).__name__ == "Conv2D")

    def hook(mod, inp, out):
        if type(mod).__name__ == "Conv2D":
            kh, kw = mod.kernel_size
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) \
                * kh * kw
        else:
            total[0] += 2 * out.numel() * mod.in_features
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if type(m).__name__ in ("Conv2D", "Linear")]
    was_training = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, first.in_channels, size, size,
                          device=next(model.parameters()).device))
    model.train(was_training)
    for h in hooks:
        h.remove()
    return total[0]


def main():
    global _ONLY
    if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3:
        _ONLY = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        print("usage: python3 chip_smoke.py [--only PHASE[,PHASE...]]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    import numpy as np
    from paddle_tpu_torch.inference.lora import AdapterRegistry, LoRALayout
    from paddle_tpu_torch.inference.spec_decode import Drafter, SpecConfig
    from paddle_tpu_torch.inference import (PagedLlamaDecoder,
                                            SamplingParams, ServingEngine)
    from paddle_tpu_torch.inference.programs import ProgramSet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.inference import PagedGPTDecoder
    from paddle_tpu_torch.models import (DiT, GPTForCausalLM,
                                         LlamaForCausalLM, MoEConfig,
                                         MoEForCausalLM, dit_tiny,
                                         dit_xl_2, ernie_45_dense_3b,
                                         gpt_345m, gpt_tiny, llama_1b,
                                         llama_3_8b, llama_mid, llama_tiny,
                                         moe_tiny, deepseek_moe_16b_like,
                                         qwen2_moe_a14b_like)
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm)
    from paddle_tpu_torch.optimizer import lr as lr_sched
    from paddle_tpu_torch.nn import MoELayer
    from paddle_tpu_torch.ops import moe as moe_ops
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.models.generation import _setup_decode
    from paddle_tpu_torch.ops import flash_attention as pfa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import decode_matmul as dmm
    from paddle_tpu_torch.ops.cuda import flash_attention as cfa
    from paddle_tpu_torch.ops.cuda import paged_attention_decode as pdc
    from paddle_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.qweight import QWeight
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            Momentum)
    from paddle_tpu_torch.vision import models as vision_models
    from paddle_tpu_torch.distributed import ProcessMesh, fleet
    from paddle_tpu_torch.utils import prng
    from paddle_tpu_torch.utils.chaos import ChaosMonkey
    from paddle_tpu_torch.inference import Router
    from paddle_tpu_torch.utils.telemetry import (CompileWatch, SLOMonitor,
                                                  SLOPolicy, Tracer)

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
        # DiT-XL/2's head_dim: float32 on CUDA cores, bf16 on the Hopper
        # kernels, the forward's registers those of d 128 and no spills
        d72 = [f"flash_{k}_kernel<f32,72>" for k in ("fwd", "bwd_dq",
                                                     "bwd_dkv")]
        _require(all(n in ptxas["flash_attention.cu"] for n in d72),
                 f"ptxas reports no head_dim 72 flash kernels: "
                 f"{sorted(ptxas['flash_attention.cu'])}")
        fwd72 = " ".join(ptxas["flash_attention_wg.cu"].get(
            "flash_wg::fwd_kernel<bf16,72>", []))
        used = re.search(r"Used (\d+) registers", fwd72)
        _require(used and int(used.group(1)) >= 168
                 and "0 bytes spill stores, 0 bytes spill loads" in fwd72,
                 f"ptxas: fwd_kernel<72> wants >= 168 registers and no "
                 f"spills: {fwd72!r}")
        ptxas["decode_matmul.cu"] = _gemv_ptxas(
            _build.build_info.get("ptxas", {}).get("decode_matmul.cu", ""))
        smem = {f"{kern}<{dn},{d}>": cfa.smem_bytes(kern, d, dt)
                for kern in ("fwd", "dq", "dkv") for d in cfa.HEAD_DIMS
                for dn, dt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16))}
        # the Hopper forward at 72 holds d 128's padded tiles
        _require(smem["fwd<bf16,72>"] == smem["fwd<bf16,128>"],
                 f"fwd<bf16,72> asks for {smem['fwd<bf16,72>']} B of shared "
                 f"memory, not d 128's {smem['fwd<bf16,128>']}")
        # the Hopper flash kernels' setmaxnreg 24/240 split over 384
        # threads waits forever below 168 registers a thread; a launch
        # refuses such a build, and so does this phase
        regs = {name: cfa.kernel_regs(kern, d)
                for name, (kern, d) in _flash_wg_kernels(cfa).items()}
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
                "flash_wg_sass": _flash_sass(sass, cfa),
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
            if spec["name"] == "f32_1b_w8_ctx512":
                heads["f32_ragged"] = c
            if spec["name"].startswith(("tp2_", "tp4_", "ernie_")):
                heads[spec["name"]] = c
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
        # float32 x: the CUDA-core kernel the tiny float32 models and
        # serve-model-1b take
        gemv_case("int4_halves_f32", "wo", 8)
        heads["f32_gemv"] = gemv_case("int4_halves_f32", "1b_wgu", 8)
        # a tp-2 shard's products (serve-tp2-int4): decode rows and the
        # widest rung the GEMV takes
        for name in SHAPES_8B_TP2:
            for b in (8, 32):
                c = gemv_case("int4_halves", name, b)
                if b == 8:
                    heads[f"gemv_{name}"] = c
        # ernie_45_dense_3b's products: decode rows and the widest rung
        for name in SHAPES_ERNIE:
            for b in (8, 32):
                c = gemv_case("int4_halves", name, b)
                if b == 8:
                    heads[f"gemv_{name}"] = c
        for spec in DECODE_CASES:
            c = _decode_check(torch, gen, timer, spec)
            cases.append(c)
            if spec["name"] == "8b_b8_ctx512":
                heads["paged_decode"] = c
            if spec["name"] == "f32_1b_b8_ctx512":
                heads["f32_decode"] = c
            if spec["name"] == "ernie_b8_ctx512":
                heads["ernie_decode"] = c
        for spec in FLASH_CASES:
            c = flash_case(**spec)
            cases.append(c)
            if spec["name"] == "llama_mid":
                heads["flash"] = c
            if spec["name"] == "f32_1b_b4_s256":
                heads["f32_flash"] = c
            if spec["name"] == "gpt_345m":
                heads["gpt_flash"] = c
            if spec["name"] in ("dit_xl2", "f32_dit_xl2", "moe_d64",
                                "deepseek_moe_16b", "qwen2_moe_a14b",
                                "tp4_8b"):
                heads[spec["name"]] = c
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

    def flash_case(name, b, sq, sk, h, hk, d, docs=0, dtype="bfloat16",
                   causal=True, tol=2e-2):
        """The three flash kernels against flash_attention_plain (float32
        leaves, autograd for the grads) on one case: out and lse within
        tol (absolute and relative), each grad's relative max error
        below tol."""
        q, k, v, dout, qs, ks, pairs = _flash_inputs(
            torch, gen, b, sq, sk, h, hk, d, docs, dtype, causal)
        sc = d ** -0.5
        fwd = lambda: cfa.flash_fwd_cuda(q, k, v, causal, sc, qs,  # noqa
                                         ks)
        out, lse = fwd()
        _require(all(torch.equal(a, b_) for a, b_ in zip((out, lse), fwd())),
                 f"flash {name}: two forward runs differ")
        delta = cfa.flash_bwd_delta(out, dout)
        bwd_args = (q, k, v, dout, lse, delta, causal, sc, qs, ks)
        runs = [(cfa.flash_bwd_dq_cuda(*bwd_args),)
                + cfa.flash_bwd_dkv_cuda(*bwd_args) for _ in range(2)]
        (dq, dk, dv), again = runs
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b_) for a, b_ in zip(runs[0], again)),
                 f"flash {name}: two backward runs differ")
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        r_out, r_lse = pfa.flash_attention_plain(*leaves, causal, sc, qs,
                                                 ks)
        (r_out * dout.float()).sum().backward()
        r_out, r_lse = r_out.detach(), r_lse.detach()
        for got, ref, what in ((out.float(), r_out, "out"),
                               (lse, r_lse, "lse")):
            err = float((got - ref).abs().max())
            _require(torch.allclose(got, ref, atol=tol, rtol=tol),
                     f"flash {name}: {what} differs from the plain "
                     f"version by {err}")
        rel = {}
        for got, leaf, what in ((dq, leaves[0], "dq"), (dk, leaves[1], "dk"),
                                (dv, leaves[2], "dv")):
            ref = leaf.grad
            rel[what] = float((got.float() - ref).abs().max()
                              / ref.abs().max().clamp(min=1e-9))
            _require(rel[what] < tol, f"flash {name}: {what} relative max "
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
                q, k, v, causal, sc, qs, ks), iters=3)
        p_out = pfa.flash_attention_plain(*pl, causal, sc, qs, ks)[0]
        plain_bwd = timer(lambda: torch.autograd.grad(
            p_out, pl, dout, retain_graph=True), iters=3)
        del p_out, pl
        lib = {"fwd": None, "dq": None, "dkv": None}
        if sq == sk and qs is None:
            # the yardstick only: one PyTorch call, never used by the port
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib["fwd"] = timer(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True))
            ll = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            l_out = sdpa(*ll, is_causal=causal, enable_gqa=True)
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
                              docs=docs, causal=causal, dtype=dtype),
                "tol": tol,
                "tflops": tflops, "bound_share": share,
                "sdpa_ratio": sdpa_ratio,
                "visible_pairs_per_head": pairs, "masked_rows": masked,
                "max_abs_err": err, "grad_rel_err": rel,
                "fwd_bit_identical": True, "bwd_bit_identical": True,
                "ms": ms,
                "plain_ms": {"fwd": plain_fwd, "dq": plain_bwd,
                             "dkv": plain_bwd},
                "library_ms": lib,
                "bound_ms": {k_: b_[0] for k_, b_ in bound.items()},
                "bound_by": {k_: b_[1] for k_, b_ in bound.items()}}

    heads = {}
    _phase("kernels", kernels)
    torch.cuda.empty_cache()

    # -- MoE at full width: DeepSeek-MoE-16B and Qwen2-MoE-A14B, cut in depth,
    # under the DeepSeekMoE recipe (recompute, AdamW, warmup and steps,
    # the MoE global-norm clip). Right after the kernels, while the card is
    # empty: the depth is what the card holds, and in a whole run the later
    # phases leave ~14 GB with the allocator ---------------------------------
    full_launches = {}

    def full_cfg(name, depth, recompute=True):
        fn = {"deepseek": deepseek_moe_16b_like,
              "qwen": qwen2_moe_a14b_like}[name]
        return fn(dtype="bfloat16", moe_dispatch_mode="ragged",
                  chunked_ce_tokens=1024, use_recompute=recompute,
                  recompute_granularity="full", num_hidden_layers=depth)

    def moe_arith(mcfg):
        """Parameters of the embedding + untied head + final norm, of a
        dense layer and of a MoE layer, from the config's widths."""
        h, v = mcfg.hidden_size, mcfg.vocab_size
        hd = h // mcfg.num_attention_heads
        attn = (2 * h * mcfg.num_attention_heads * hd
                + 2 * h * mcfg.num_key_value_heads * hd + 2 * h)
        e, hm = mcfg.num_experts, mcfg.moe_intermediate_size
        return {"embed_head_norm": 2 * v * h + h,
                "dense_layer": attn + 3 * h * mcfg.intermediate_size,
                "moe_layer": (attn + h * e + 2 * e * h * hm
                              + 3 * h * hm * mcfg.num_shared_experts),
                "experts_of_a_layer": 2 * e * h * hm}

    def full_params(mcfg, depth):
        a = moe_arith(mcfg)
        dense = min(mcfg.first_k_dense_replace, depth)
        return (a["embed_head_norm"] + dense * a["dense_layer"]
                + (depth - dense) * a["moe_layer"])

    # float32 weight, grad and AdamW m / v (bf16 gains: the parameter and
    # its grad in bf16 plus a float32 master) a parameter
    STATE_BYTES = 16

    def full_trainer(mcfg, b=2, s=4096):
        """A model from seed 0 under the recipe (DeepSeekMoE paper §5.1,
        its step counts cut): AdamW(β 0.9 / 0.95, weight decay 0.1),
        LinearWarmup(MultiStepDecay(4.2e-4, [8, 9], 0.316), 4 steps from
        0), ClipGradForMOEByGlobalNorm(1.0) over the experts' w1 / w2;
        ids b x s from RandomState(0). step() is one eager training step
        (forward, loss, backward, the clip's expert / dense split of the
        squared norm, AdamW, clear_grad, the scheduler's step) and
        appends (loss, lr, clip norm, clip scale, expert sq, dense sq),
        the tensors unread, to the log."""
        model = MoEForCausalLM(mcfg, seed=0, device="cuda")
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
            0, mcfg.vocab_size, size=(b, s)).astype(np.int32), device="cuda")
        log = []

        def step():
            lr_now = opt.get_lr()
            loss = model.loss(model(ids), ids)
            loss.backward()
            ex, dn = clip.partition_norms(params, [p.grad for p in params])
            opt.step()
            opt.clear_grad()
            sched.step()
            log.append((loss.detach(), lr_now, clip.last_global_norm,
                        clip.last_scale, ex, dn))

        return {"model": model, "opt": opt, "clip": clip, "step": step,
                "log": log, "params": params, "ids": ids}

    def read_log(log):
        rows = []
        for loss, lr_now, norm, scale, ex, dn in log:
            ex, dn = float(ex), float(dn)
            rows.append({"loss": float(loss), "lr": lr_now,
                         "clip_global_norm": float(norm),
                         "clip_scale": float(scale),
                         "expert_share_of_sq_norm": ex / (ex + dn),
                         "partition_norm": (ex + dn) ** 0.5})
        for r in rows:
            _require(np.isfinite(r["loss"]) and np.isfinite(
                r["clip_global_norm"]), f"train-moe-full: step {r}")
            # the clip's own norm is the split's, over every gradient
            _require(abs(r["partition_norm"] - r["clip_global_norm"])
                     <= 1e-3 * r["clip_global_norm"],
                     f"train-moe-full: clip norm {r['clip_global_norm']} "
                     f"against its expert / dense split "
                     f"{r['partition_norm']}")
        return rows

    def memory_now():
        """(free bytes on the card, bytes torch's allocator holds)."""
        return torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def full_depth(name, probe_depth, free0, reserved0):
        """The deepest depth whose peak leaves 8 GB of the card free: one
        step of the recipe at probe_depth gives what the peak holds
        besides the training state (activations, recompute, AdamW's
        temporaries, the allocator's slack); the state grows by
        STATE_BYTES a parameter of each added MoE layer."""
        mcfg = full_cfg(name, probe_depth)
        tr = full_trainer(mcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr["step"]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_reserved() - reserved0
        n = full_params(mcfg, probe_depth)
        _require(tr["model"].num_params() == n,
                 f"train-moe-full {name}: {tr['model'].num_params()} "
                 f"parameters, the arithmetic says {n}")
        other = peak - STATE_BYTES * n
        del tr
        release()
        # each added layer also keeps its bf16 input for the recompute
        saved = 2 * 2 * 4096 * mcfg.hidden_size
        depth = probe_depth
        while depth < 28 and free0 - (
                STATE_BYTES * full_params(mcfg, depth + 1) + other
                + (depth + 1 - probe_depth) * saved) >= 8.5e9:
            depth += 1
        return depth, {"probe_depth": probe_depth,
                       "probe_peak_gb": peak / 1e9,
                       "probe_other_than_state_gb": other / 1e9}

    def full_row(name, depth, warm, iters, free0, reserved0):
        """warm + iters recipe steps at depth, then one traced step. The
        flash counters, set to 0 just before the steps and read just
        after, must read 2 * depth forwards (the forward and its
        recomputation) and depth dq and dk/dv a step; the traced step
        the same of flash_wg::*<bf16,128> and no other flash kernel. When
        the warm steps' peak leaves under 8 GB free (the allocator's
        slack grows with depth), the run starts again one layer
        shallower."""
        dropped = []
        while True:
            mcfg = full_cfg(name, depth)
            t0 = time.perf_counter()
            tr = full_trainer(mcfg)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            reset_flash()
            for _ in range(warm):
                tr["step"]()
            torch.cuda.synchronize()
            free_warm = free0 - (torch.cuda.max_memory_reserved() - reserved0)
            if free_warm >= 8e9 or depth == 1:
                break
            dropped.append({"depth": depth, "free_gb": free_warm / 1e9})
            del tr
            release()
            depth -= 1
        model, b, s = tr["model"], *tr["ids"].shape
        t0 = time.perf_counter()
        for _ in range(iters):
            tr["step"]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = flash_counts()
        n_steps = warm + iters
        full_launches[name] = dict(launched)
        _require(launched == {"flash_fwd": 2 * depth * n_steps,
                              "flash_bwd_dq": depth * n_steps,
                              "flash_bwd_dkv": depth * n_steps},
                 f"train-moe-full {name}: {n_steps} steps launched "
                 f"{launched}, expected {2 * depth} forwards and {depth} "
                 f"dq and dk/dv a step")
        _require(all(v == 0 for v in counts().values()),
                 f"train-moe-full {name} launched serving kernels: "
                 f"{counts()}")
        peak_reserved = torch.cuda.max_memory_reserved()
        peak_alloc = torch.cuda.max_memory_allocated()
        free_at_peak = free0 - (peak_reserved - reserved0)
        _require(free_at_peak >= 8e9,
                 f"train-moe-full {name}: {free_at_peak / 1e9:.2f} GB free "
                 f"at the peak of depth {depth}")
        step_ms = wall * 1e3 / iters
        tok_s = b * s * iters / wall
        n_params = model.num_params()
        n_act = model.num_activated_params()
        hd = mcfg.hidden_size // mcfg.num_attention_heads
        fpt = 6 * n_act + 12 * depth * mcfg.num_attention_heads * hd * s
        # the clip's passes alone on a step's gradients: the norm (a read
        # of every gradient) and the scaling (a read and a write), which
        # AdamW's loop runs one gradient at a time
        loss = model.loss(model(tr["ids"]), tr["ids"])
        loss.backward()
        grads = [p.grad for p in tr["params"]]
        clip = tr["clip"]
        groups = list(range(len(grads)))
        norm_ms = timer(lambda: clip._plan(grads, groups), iters=3)
        one = clip._plan(grads, groups)

        def scale_pass():
            for i, g in enumerate(grads):
                one(g, i)

        scale_ms = timer(scale_pass, iters=3)
        split_ms = timer(lambda: clip.partition_norms(tr["params"], grads),
                         iters=3)
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        tr["opt"].clear_grad()
        del loss, grads, one
        # one traced step, the scheduler's 13th value: the second decay
        want = {f"flash_wg::{k}_kernel<bf16,{hd}>": (2 if k == "fwd" else 1)
                * depth for k in ("fwd", "dq", "dkv")}
        for pads in (_PAD_LAUNCHES, 32768, 131072):
            prof = _device_breakdown(torch, tr["step"], step_ms, pads)
            if prof["pad_records_lost"] is not None:
                break
        _require(prof["pad_records_lost"] is not None,
                 f"train-moe-full {name}: the profiler lost all {pads} pad "
                 f"records of a traced step")
        traced = {n: c for n, (c, _ms) in prof["flash_kernels"].items()
                  if "piece_sum" not in n}
        _require(traced == want,
                 f"train-moe-full {name}: a traced step's flash kernels "
                 f"were {traced}, not {want}")
        steps = read_log(tr["log"])
        losses = [r["loss"] for r in steps]
        _require(losses[warm + iters - 1] < losses[0],
                 f"train-moe-full {name}: the loss did not fall: {losses}")
        fam = prof["device_ms_by_family"]
        flash_ms = sum(v for k_, v in fam.items() if k_.startswith("flash"))
        gemm_ms = fam.get("library_gemm", 0.0)
        a = moe_arith(mcfg)
        row = {"config": f"{name} full width, {depth} of 28 layers",
               "depth": depth, "depths_dropped": dropped,
               "hidden": mcfg.hidden_size,
               "heads": [mcfg.num_attention_heads,
                         mcfg.num_key_value_heads],
               "experts": [mcfg.num_experts, mcfg.num_experts_per_tok,
                           mcfg.moe_intermediate_size,
                           mcfg.num_shared_experts],
               "batch": [b, s], "init_s": init_s,
               "parameter_arithmetic": dict(
                   a, total=n_params, activated=n_act,
                   state_bytes_per_parameter=STATE_BYTES,
                   state_gb=STATE_BYTES * n_params / 1e9,
                   state_gb_per_moe_layer=STATE_BYTES * a["moe_layer"] / 1e9),
               "num_params": n_params, "num_activated_params": n_act,
               "launches": launched,
               "flash_launches_per_step": {
                   k_: v // n_steps for k_, v in launched.items()},
               "steps": steps, "warm": warm, "timed": iters,
               "step_ms": step_ms, "tokens_per_s": tok_s,
               "mfu_activated": tok_s * fpt / BF16_FLOPS_PER_S,
               "flops_per_token": fpt,
               "peak_allocated_gb": peak_alloc / 1e9,
               "peak_reserved_gb": peak_reserved / 1e9,
               "free_at_peak_gb": free_at_peak / 1e9,
               "device_ms_flash_gemm_other": [
                   flash_ms, gemm_ms, prof["device_ms"] - flash_ms - gemm_ms],
               "clip_alone_ms": {"norm": norm_ms, "scale": scale_ms,
                                 "expert_dense_split": split_ms,
                                 "grad_gb": grad_bytes / 1e9,
                                 "norm_and_scale_share_of_device_ms":
                                     (norm_ms + scale_ms) / prof["device_ms"]},
               "traced_flash_launches": traced, "step_profile": prof}
        del tr, model
        release()
        return row

    def recompute_on_off(depth=3, rounds=3):
        """The DeepSeek recipe at depth with and without recompute, both
        models from seed 0 and resident: each one's first step (loss
        within 1e-3 relative, clip norm within 1e-2: the ragged combine's
        index_add sums with atomics), then steps alternated, each with its
        peak over what was allocated before it."""
        runs = {rc: full_trainer(full_cfg("deepseek", depth, rc))
                for rc in (True, False)}
        step_ms = {True: [], False: []}
        peak = {True: [], False: []}
        for _ in range(rounds):
            for rc, tr in runs.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                tr["step"]()
                torch.cuda.synchronize()
                step_ms[rc].append((time.perf_counter() - t1) * 1e3)
                peak[rc].append((torch.cuda.max_memory_allocated() - base)
                                / 1e9)
        del tr
        first = {rc: read_log(t_["log"])[0] for rc, t_ in runs.items()}
        loss_rel = abs(first[True]["loss"] - first[False]["loss"]) \
            / abs(first[False]["loss"])
        norm_rel = abs(first[True]["clip_global_norm"]
                       - first[False]["clip_global_norm"]) \
            / first[False]["clip_global_norm"]
        _require(loss_rel <= 1e-3 and norm_rel <= 1e-2,
                 f"train-moe-full recompute on / off: first-step loss "
                 f"{first[True]['loss']} / {first[False]['loss']}, clip norm "
                 f"{first[True]['clip_global_norm']} / "
                 f"{first[False]['clip_global_norm']}")
        del runs
        release()
        key = {True: "recompute", False: "plain"}
        return {"depth": depth, "first_step": {key[rc]: first[rc]
                                               for rc in first},
                "loss_rel_diff": loss_rel, "clip_norm_rel_diff": norm_rel,
                # the first round builds AdamW's state; later ones time
                "step_ms_alternated": {key[rc]: v for rc, v in
                                       step_ms.items()},
                "step_peak_over_resident_gb": {key[rc]: v for rc, v in
                                               peak.items()}}

    def train_moe_full():
        """DeepSeek-MoE-16B and Qwen2-MoE-A14B at full width under the
        DeepSeekMoE recipe, depth cut to what one card holds: recompute
        on against off at depth 3; DeepSeek at the deepest depth that
        leaves 8 GB free at its peak, 2 warm + 10 timed steps; Qwen at its
        deepest, 2 warm + 4 timed; each then one traced step."""
        out = {"nvidia_smi": smi}
        release()
        free0, reserved0 = memory_now()
        out["free_at_start_gb"] = free0 / 1e9
        out["reserved_at_start_gb"] = reserved0 / 1e9
        out["recompute_on_off"] = recompute_on_off()
        for name, probe, warm, iters in (("deepseek", 3, 2, 10),
                                         ("qwen", 1, 2, 4)):
            free0, reserved0 = memory_now()
            depth, fit = full_depth(name, probe, free0, reserved0)
            row = full_row(name, depth, warm, iters, free0, reserved0)
            row["depth_fit"] = fit
            # the next layer would leave less than 8 GB
            row["free_at_peak_with_one_more_layer_gb"] = (
                row["free_at_peak_gb"] - STATE_BYTES
                * moe_arith(full_cfg(name, depth))["moe_layer"] / 1e9)
            out[name] = row
        return out

    _phase("train-moe-full", train_moe_full)

    # -- ResNet: convolutions, BatchNorm with running stats, pooling, -------
    # -- Momentum --------------------------------------------------------
    def damp_residuals(model, gain=0.1):
        """Each residual branch's last BatchNorm gain set to ``gain`` (bn2
        of a BasicBlock, bn3 of a bottleneck), as tests/test_torch_vision
        sets it: at gain 1 a seeded ResNeXt-50 in train mode is chaotic
        at a batch of 4, and the card and the CPU would part by more
        than their rounding."""
        last = "bn3" if hasattr(model.layer1[0], "bn3") else "bn2"
        with torch.no_grad():
            for stage in (model.layer1, model.layer2, model.layer3,
                          model.layer4):
                for blk in stage:
                    getattr(blk, last).weight.fill_(gain)

    def tiny_resnet_parity():
        """resnet18 (BasicBlock) and resnext50_32x4d (bottleneck, groups
        32), num_classes 10, float32, b 4 x 3 x 64 x 64, the same state
        on the card and the CPU (residual gains 0.1): a train-mode
        forward (logits within 1e-4 of the largest |logit|, running
        stats within 1e-5), an eval forward (1e-4), three TrainSteps of
        Momentum(0.01, 0.9) (losses within 1e-4 relative; at lr 0.1 the
        four pictures are fitted and the losses are exactly 0 by the
        second step), the stats after them within 1e-3; and max_pool2d's
        output and mask on the same stem activations and on the input
        (ceil mode, per-side padding) equal on both."""
        out = {}
        rng = np.random.RandomState(5)
        x_np = rng.randn(4, 3, 64, 64).astype(np.float32)
        y_np = rng.randint(0, 10, 4).astype(np.int64)
        for name in ("resnet18", "resnext50_32x4d"):
            ctor = getattr(vision_models, name)
            cpu = ctor(num_classes=10, seed=0, device="cpu")
            damp_residuals(cpu)
            gpu = ctor(num_classes=10, seed=1, device="cuda")
            gpu.load_state_dict(cpu.state_dict())
            stats0 = [b_.clone() for b_ in cpu.buffers()]
            res = {}
            for key, m in (("cpu", cpu), ("cuda", gpu)):
                dev = next(m.parameters()).device
                x = torch.as_tensor(x_np, device=dev)
                y = torch.as_tensor(y_np, device=dev)
                with torch.no_grad():
                    logits = m(x).cpu()
                    stats1 = [b_.cpu().clone() for b_ in m.buffers()]
                    m.eval()
                    logits_eval = m(x).cpu()
                    stem = m.relu(m.bn1(m.conv1(x)))
                    m.train()
                step = TrainStep(m, lambda o, l: F.cross_entropy(o, l),
                                 Momentum(learning_rate=0.01, momentum=0.9,
                                          parameters=m.parameters()))
                losses = [float(step(x, y)) for _ in range(3)]
                res[key] = dict(logits=logits, logits_eval=logits_eval,
                                stats1=stats1, losses=losses,
                                stats3=[b_.cpu() for b_ in m.buffers()],
                                stem=stem.cpu())
            c, g = res["cpu"], res["cuda"]

            def rel(a, b_):
                return float((a - b_).abs().max() / b_.abs().max())
            err = {"train_logits": rel(g["logits"], c["logits"]),
                   "eval_logits": rel(g["logits_eval"], c["logits_eval"]),
                   "stats_after_forward": max(
                       float((a - b_).abs().max())
                       for a, b_ in zip(g["stats1"], c["stats1"])),
                   "stats_after_steps": max(
                       float((a - b_).abs().max())
                       for a, b_ in zip(g["stats3"], c["stats3"])),
                   "losses": max(abs(a - b_) / abs(b_) for a, b_ in
                                 zip(g["losses"], c["losses"]))}
            _require(err["train_logits"] <= 1e-4
                     and err["eval_logits"] <= 1e-4,
                     f"tiny-resnet-parity {name}: logits differ {err}")
            _require(err["stats_after_forward"] <= 1e-5
                     and err["stats_after_steps"] <= 1e-3,
                     f"tiny-resnet-parity {name}: running stats {err}")
            _require(err["losses"] <= 1e-4 and all(
                np.isfinite(c["losses"] + g["losses"])),
                f"tiny-resnet-parity {name}: losses cpu {c['losses']} "
                f"cuda {g['losses']}")
            _require(all(not torch.equal(a, b_) for a, b_ in
                         zip(c["stats3"], stats0)),
                     f"tiny-resnet-parity {name}: running stats did not "
                     f"move")
            # the max-pool mask on identical inputs: the stem's
            # activations (ties at 0 after the ReLU) and the input under
            # ceil mode with per-side padding
            masks = {}
            for what, t, kw in (
                    ("stem_k3s2p1", c["stem"], dict(kernel_size=3, stride=2,
                                                     padding=1)),
                    ("input_ceil_per_side", torch.as_tensor(x_np),
                     dict(kernel_size=2, stride=2, padding=[[0, 1], [1, 0]],
                          ceil_mode=True))):
                vc, mc = F.max_pool2d(t, return_mask=True, **kw)
                vg, mg = F.max_pool2d(t.cuda(), return_mask=True, **kw)
                _require(torch.equal(vg.cpu(), vc)
                         and torch.equal(mg.cpu(), mc),
                         f"tiny-resnet-parity {name}: max_pool2d {what} "
                         f"differs on the card")
                masks[what] = list(mc.shape)
            out[name] = {"errors": err, "losses_cpu": c["losses"],
                         "losses_cuda": g["losses"], "max_pool_masks": masks}
            del cpu, gpu, res, c, g, stats0
        gc.collect()
        torch.cuda.empty_cache()
        return out

    _phase("tiny-resnet-parity", tiny_resnet_parity)

    def train_resnet50():
        """bench.py's resnet row (bench.py:445-476) at full width and
        depth: resnet50(num_classes=1000, seed=0) with every parameter
        cast to bf16 (buffers float32), Momentum(0.1, 0.9) with float32
        masters, cross entropy in float32, b 256 x 3 x 224 x 224 bf16
        from RandomState(0) as bench.py draws it: 2 warm and 10 timed
        TrainSteps. Every loss finite and the running stats moved. Step
        ms, imgs/s, MFU (3 x the forward FLOPs counted from the layers'
        shapes, over 989 TFLOP/s), peak memory, device ms by family and
        the idle share of a step, and the optimizer's update alone."""
        b, warm, iters = 256, 2, 10
        t0 = time.perf_counter()
        model = vision_models.resnet50(num_classes=1000, seed=0,
                                       device="cuda")
        fwd_flops = _conv_fc_flops(torch, model, 224)
        for p_ in model.parameters():       # bf16 weights, f32 masters
            p_.data = p_.data.to(torch.bfloat16)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        step = TrainStep(model, lambda o, l: F.cross_entropy(o.float(), l),
                         opt)
        rng = np.random.RandomState(0)
        x = torch.as_tensor(rng.randn(b, 3, 224, 224).astype(np.float32),
                            device="cuda").to(torch.bfloat16)
        y = torch.as_tensor(rng.randint(0, 1000, b).astype(np.int64),
                            device="cuda")
        stats0 = [b_.clone() for b_ in model.buffers()]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_flash()
        losses = [step(x, y) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(x, y) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        _require(all(np.isfinite(losses)),
                 f"train-resnet50 losses {losses}")
        moved = sum(int(not torch.equal(a, b_)) for a, b_ in
                    zip(stats0, model.buffers()))
        _require(moved == len(stats0),
                 f"train-resnet50: {len(stats0) - moved} of {len(stats0)} "
                 f"running stats did not move")
        _require(all(p_.dtype == torch.bfloat16 for p_ in model.parameters())
                 and all(b_.dtype == torch.float32 for b_ in model.buffers()),
                 "train-resnet50: parameter / buffer dtypes changed")
        _require(all(v == 0 for v in counts().values())
                 and all(v == 0 for v in flash_counts().values()),
                 f"train-resnet50 launched port kernels: {counts()} "
                 f"{flash_counts()}")
        step_ms = wall * 1e3 / iters
        imgs_s = b * iters / wall
        peak_alloc = torch.cuda.max_memory_allocated() / 1e9
        peak_reserved = torch.cuda.max_memory_reserved() / 1e9
        prof = _device_breakdown(torch, lambda: step(x, y), step_ms)
        # the optimizer's update alone, on one step's gradients
        opt.clear_grad()
        F.cross_entropy(model(x).float(), y).backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        opt_wall_ms = (time.perf_counter() - t1) * 1e3
        opt_events, _lost = _kernel_events(torch, opt.step)
        opt_device_ms = sum(us for _c, us in opt_events.values()) / 1e3
        opt.clear_grad()
        n_params = model.num_params()
        del model, opt, step, x, y, stats0
        gc.collect()
        torch.cuda.empty_cache()
        return {"model": "ResNet-50, bf16 parameters (float32 masters in "
                         "Momentum(0.1, 0.9)), float32 running stats, b 256 "
                         "x 3 x 224 x 224 bf16, cross entropy in float32",
                "num_params": n_params, "init_s": init_s, "steps":
                warm + iters, "losses": losses, "step_ms": step_ms,
                "imgs_per_s": imgs_s,
                "mfu": imgs_s * 3 * fwd_flops / BF16_FLOPS_PER_S,
                "fwd_flops_per_img": fwd_flops,
                "peak_mem_allocated_gb": peak_alloc,
                "peak_mem_reserved_gb": peak_reserved,
                "optimizer_update": {"device_ms": opt_device_ms,
                                     "wall_ms": opt_wall_ms,
                                     "kernels": sum(
                                         c_ for c_, _us in
                                         opt_events.values())},
                "nvidia_smi": smi, "step_profile": prof}

    _phase("train-resnet50", train_resnet50)

    # -- the vision zoo: depthwise convolutions, ReLU6 / Hardswish /
    # -- Hardsigmoid / Swish, squeeze-excitation, Dropout on a card
    # -- generator, conv2d's padding forms ---------------------------------
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.vision.models.mobilenetv3 import SqueezeExcitation

    def port_launches():
        return dict(counts(), **flash_counts(),
                    paged_attention_decode=pdc.launches)

    def reset_port_launches():
        reset_counts()
        reset_flash()
        pdc.launches = 0

    def no_dropout(model):
        for m in model.modules():
            if isinstance(m, pnn.Dropout):
                m.p = 0.0

    def zoo_loss(out, label):
        """Cross entropy in float32; GoogLeNet's main + 0.3 x (aux1 +
        aux2) in training (Szegedy et al.)."""
        if isinstance(out, tuple):
            main, aux1, aux2 = out
            loss = F.cross_entropy(main.float(), label)
            if aux1 is not None:
                loss = loss + 0.3 * (F.cross_entropy(aux1.float(), label)
                                     + F.cross_entropy(aux2.float(), label))
            return loss
        return F.cross_entropy(out.float(), label)

    def main_out(out):
        return out[0] if isinstance(out, tuple) else out

    # one constructor of each family at a narrow width: (constructor,
    # arguments, input shape)
    ZOO_TINY = (
        ("LeNet", {}, (4, 1, 28, 28)),
        ("alexnet", {}, (4, 3, 64, 64)),
        ("vgg11", dict(batch_norm=True), (4, 3, 64, 64)),
        ("mobilenet_v1", dict(scale=0.25), (4, 3, 64, 64)),
        ("mobilenet_v2", dict(scale=0.25), (4, 3, 64, 64)),
        ("mobilenet_v3_large", dict(scale=0.5), (4, 3, 64, 64)),
        ("squeezenet1_1", {}, (4, 3, 64, 64)),
        ("densenet121", {}, (4, 3, 128, 128)),
        ("googlenet", {}, (4, 3, 64, 64)),
        ("inception_v3", {}, (4, 3, 128, 128)),
        ("shufflenet_v2_x0_5", {}, (4, 3, 64, 64)),
    )

    def tiny_vision_parity():
        """One constructor of each family at a narrow width, num_classes
        10, float32 (TF32 off), the same state on the card and the CPU
        (each BatchNorm's shift set to ZOO_BN_SHIFT, as the CPU tests set
        it: BatchNorm stacks at init are chaotic in train mode at a batch
        of 4, and the card and the CPU would part by more than their
        rounding), every Dropout's p 0 (the two devices' generators draw
        different streams): a train-mode forward (logits within 1e-4 of
        the largest |logit|, running stats within 1e-5), an eval forward
        (1e-4), three TrainSteps of Momentum(0.01, 0.9) (losses within
        1e-4 relative; InceptionV3's in eval mode). Then Dropout's rule
        on the card at p 0.2 / 0.5 over 2^20 values (the kept fraction
        within 4 sigma of 1 - p, kept values x / (1 - p) bit for bit
        against the CPU's division) and conv2d's "SAME" at stride 2 and
        NHWC card against CPU (1e-5).
        No port kernel launches. A later step's loss is held within 1e-4
        of the larger of itself and the first step's loss: the card's own
        third SqueezeNet loss takes two values 1.2e-4 apart from run to
        run, cuDNN on or off (tools/vision_parity_probe.py), a near-tie
        that the first update's last bits decide."""
        reset_port_launches()
        out = {}
        for name, kw, shape in ZOO_TINY:
            ctor = getattr(vision_models, name)
            nc = {} if name == "LeNet" else {"num_classes": 10}
            cpu = ctor(seed=0, device="cpu", **nc, **kw)
            with torch.no_grad():
                for m in cpu.modules():
                    if isinstance(m, pnn.BatchNorm2D):
                        m.bias.fill_(ZOO_BN_SHIFT)
            gpu = ctor(seed=1, device="cuda", **nc, **kw)
            gpu.load_state_dict(cpu.state_dict())
            rng = np.random.RandomState(5)
            x_np = rng.randn(*shape).astype(np.float32)
            y_np = rng.randint(0, 10, shape[0]).astype(np.int64)
            res = {}
            for key, m in (("cpu", cpu), ("cuda", gpu)):
                no_dropout(m)
                dev = next(m.parameters()).device
                x = torch.as_tensor(x_np, device=dev)
                y = torch.as_tensor(y_np, device=dev)
                with torch.no_grad():
                    logits = main_out(m(x)).cpu()
                    stats1 = [b_.cpu().clone() for b_ in m.buffers()]
                    m.eval()
                    logits_eval = main_out(m(x)).cpu()
                    m.train()
                # InceptionV3's train-mode steps are chaotic in float32
                # at a batch of 4 (EVAL_GRADS in the CPU tests)
                m.train(name != "inception_v3")
                step = TrainStep(m, zoo_loss,
                                 Momentum(learning_rate=0.01, momentum=0.9,
                                          parameters=m.parameters()))
                losses = [float(step(x, y)) for _ in range(3)]
                m.train()
                res[key] = dict(logits=logits, logits_eval=logits_eval,
                                stats1=stats1, losses=losses)
            c, g = res["cpu"], res["cuda"]

            def rel(a, b_):
                return float((a - b_).abs().max() / b_.abs().max())
            err = {"train_logits": rel(g["logits"], c["logits"]),
                   "eval_logits": rel(g["logits_eval"], c["logits_eval"]),
                   "stats_after_forward": max(
                       (float((a - b_).abs().max()) for a, b_ in
                        zip(g["stats1"], c["stats1"])), default=0.0),
                   # relative to the first step's loss where the steps
                   # have driven it lower (docstring); AlexNet's and
                   # VGG's heads fit four pictures to a loss of 0
                   "losses": max(abs(a - b_) / max(abs(b_),
                                                   abs(c["losses"][0]))
                                 for a, b_ in zip(g["losses"],
                                                  c["losses"]))}
            _require(err["train_logits"] <= 1e-4
                     and err["eval_logits"] <= 1e-4,
                     f"tiny-vision-parity {name}: logits differ {err}")
            _require(err["stats_after_forward"] <= 1e-5,
                     f"tiny-vision-parity {name}: running stats {err}")
            _require(err["losses"] <= 1e-4 and all(
                np.isfinite(c["losses"] + g["losses"])),
                f"tiny-vision-parity {name}: losses cpu {c['losses']} "
                f"cuda {g['losses']}")
            out[name] = {"errors": err, "losses_cpu": c["losses"],
                         "losses_cuda": g["losses"]}
            del cpu, gpu, res, c, g
        # Dropout's rule on the card
        dgen = torch.Generator(device="cuda")
        dgen.manual_seed(0)
        x = torch.randn(1 << 20, device="cuda", generator=dgen)
        drop = {}
        for p in (0.2, 0.5):
            o = F.dropout(x, p, generator=dgen)
            keep = o != 0
            frac = float(keep.float().mean())
            sigma = (p * (1 - p) / x.numel()) ** 0.5
            want = x.cpu() / torch.tensor(1.0 - p, dtype=torch.float32)
            exact = torch.equal(o.cpu()[keep.cpu()], want[keep.cpu()])
            _require(abs(frac - (1 - p)) <= 4 * sigma and exact,
                     f"tiny-vision-parity: dropout p {p} kept {frac} "
                     f"(4 sigma {4 * sigma}), kept values exact {exact}")
            drop[f"p{p}"] = {"kept": frac, "sigmas": (frac - (1 - p)) / sigma}
        out["dropout"] = drop
        # conv2d's padding forms
        rng = np.random.RandomState(6)
        conv = {}
        for what, xs, ws, kw in (
                ("same_s2", (2, 16, 32, 32), (8, 16, 3, 3),
                 dict(stride=2, padding="SAME")),
                ("nhwc_per_side", (2, 32, 32, 16), (8, 16, 3, 3),
                 dict(padding=[1, 1, 2, 0], data_format="NHWC")),
                ("nhwc_same_s2", (2, 32, 32, 16), (16, 1, 3, 3),
                 dict(stride=2, padding="same", groups=16,
                      data_format="NHWC"))):
            xc = torch.as_tensor(rng.randn(*xs).astype(np.float32))
            wc = torch.as_tensor(rng.randn(*ws).astype(np.float32))
            bc = torch.as_tensor(rng.randn(ws[0]).astype(np.float32))
            oc = F.conv2d(xc, wc, bc, **kw)
            og = F.conv2d(xc.cuda(), wc.cuda(), bc.cuda(), **kw).cpu()
            e = float((og - oc).abs().max() / oc.abs().max())
            _require(og.shape == oc.shape and e <= 1e-5,
                     f"tiny-vision-parity: conv2d {what} {tuple(og.shape)} "
                     f"vs {tuple(oc.shape)}, error {e}")
            conv[what] = {"shape": list(og.shape), "error": e}
        out["conv2d"] = conv
        _require(not any(port_launches().values()),
                 f"tiny-vision-parity launched port kernels: "
                 f"{port_launches()}")
        gc.collect()
        torch.cuda.empty_cache()
        return out

    _phase("tiny-vision-parity", tiny_vision_parity)

    def zoo_family(name):
        """A kernel's part of a vision step, from its name."""
        low = name.lower()
        if "depthwise" in low:
            return "conv_depthwise"
        if re.search(r"conv|fprop|dgrad|wgrad", low):
            return "conv_dense"
        if any(s in low for s in ("gemm", "gemv", "nvjet", "cutlass")):
            return "library_gemm"
        if "welford" in low:
            return "batchnorm_stats"
        if re.search(r"minimum|maximum|clamp|hardtanh|threshold|hardswish|"
                     r"hardsigmoid|silu|sigmoid", low):
            return "activations"
        if "pool" in low:
            return "pooling"
        return "other"

    def alone_ms(items):
        """Device ms and launches of the modules of ``items`` ((module,
        input shape) pairs, copies of the model's) run alone, forward
        and backward, on bf16 inputs of their shapes (torch.profiler)."""
        mods = [copy.deepcopy(m).train() for m, _ in items]
        xs = [torch.randn(s, device="cuda", dtype=torch.bfloat16,
                          requires_grad=True) for _, s in items]

        def run():
            for m, xi in zip(mods, xs):
                o = m(xi)
                o.backward(torch.ones_like(o))
        run()
        events, _lost = _kernel_events(torch, run)
        return {"device_ms": sum(us for _c, us in events.values()) / 1e3,
                "launches": sum(c_ for c_, _us in events.values()),
                "modules": len(items)}

    def train_mobilenetv3():
        """THE ZOO PATH: mobilenet_v3_large(num_classes=1000, seed=0) at
        full width and depth, every parameter cast to bf16 (running stats
        float32), Dropout(0.2) active on the card generator the model
        made, Momentum(0.1, 0.9) with float32 masters, cross entropy in
        float32, b 256 x 3 x 224 x 224 bf16 from RandomState(0): 2 warm
        and 10 timed TrainSteps, then one traced. Every loss finite, the
        last timed below the first, every running stat moved, no port
        kernel launched. Step ms, imgs/s, MFU (3 x the forward FLOPs
        counted from the conv and fc shapes, over 989 TFLOP/s), peak
        memory, the idle share, device ms of the traced step by part
        (depthwise convolutions apart from the dense ones), the largest
        "other" kernels, and the parts run alone at the step's shapes:
        the depthwise and the dense convolutions, BatchNorm, the
        activations and the squeeze-excitation gates."""
        b, warm, iters = 256, 2, 10
        t0 = time.perf_counter()
        model = vision_models.mobilenet_v3_large(num_classes=1000, seed=0,
                                                 device="cuda")
        n_params = model.num_params()
        fwd_flops = _conv_fc_flops(torch, model, 224)
        # each part's modules and input shapes, from one forward
        shapes = []
        hooks = [m.register_forward_pre_hook(
            lambda m, inp: shapes.append((m, tuple(inp[0].shape))))
            for m in model.modules() if isinstance(
                m, (pnn.Conv2D, pnn.BatchNorm2D, pnn.Hardswish, pnn.ReLU,
                    SqueezeExcitation))]
        for p_ in model.parameters():       # bf16 weights, f32 masters
            p_.data = p_.data.to(torch.bfloat16)
        drops = [m for m in model.modules() if isinstance(m, pnn.Dropout)]
        _require(len(drops) == 1 and drops[0].p == 0.2
                 and drops[0].generator.device.type == "cuda",
                 "train-mobilenetv3: Dropout(0.2) on a card generator")
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        step = TrainStep(model, zoo_loss, opt)
        rng = np.random.RandomState(0)
        x = torch.as_tensor(rng.randn(b, 3, 224, 224).astype(np.float32),
                            device="cuda").to(torch.bfloat16)
        y = torch.as_tensor(rng.randint(0, 1000, b).astype(np.int64),
                            device="cuda")
        model.eval()
        with torch.no_grad():
            model(x)
        model.train()
        for h in hooks:
            h.remove()
        stats0 = [b_.clone() for b_ in model.buffers()]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_port_launches()
        losses = [step(x, y) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(x, y) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        _require(all(np.isfinite(losses)) and losses[-1] < losses[warm],
                 f"train-mobilenetv3 losses {losses}")
        moved = sum(int(not torch.equal(a, b_)) for a, b_ in
                    zip(stats0, model.buffers()))
        _require(moved == len(stats0),
                 f"train-mobilenetv3: {len(stats0) - moved} of "
                 f"{len(stats0)} running stats did not move")
        _require(not any(port_launches().values()),
                 f"train-mobilenetv3 launched port kernels: "
                 f"{port_launches()}")
        step_ms = wall * 1e3 / iters
        imgs_s = b * iters / wall
        peak_alloc = torch.cuda.max_memory_allocated() / 1e9
        peak_reserved = torch.cuda.max_memory_reserved() / 1e9
        t1 = time.perf_counter()
        events, lost = _kernel_events(torch, lambda: step(x, y))
        parts, other = {}, {}
        for name, (count, us) in events.items():
            fam = zoo_family(name)
            n = parts.setdefault(fam, [0, 0.0])
            n[0] += count
            n[1] += us / 1e3
            if fam == "other":
                other[name[:60]] = other.get(name[:60], 0.0) + us / 1e3
        busy = sum(ms for _c, ms in parts.values())
        in_se = {id(m) for se in model.modules()
                 if isinstance(se, SqueezeExcitation) for m in se.modules()}
        outside = [(m, s) for m, s in shapes if id(m) not in in_se]
        alone = {
            "conv_depthwise": alone_ms([
                (m, s) for m, s in outside if isinstance(m, pnn.Conv2D)
                and m.groups == m.in_channels > 1]),
            "conv_dense": alone_ms([
                (m, s) for m, s in outside if isinstance(m, pnn.Conv2D)
                and not m.groups == m.in_channels > 1]),
            "batchnorm": alone_ms([(m, s) for m, s in outside
                                   if isinstance(m, pnn.BatchNorm2D)]),
            "activations": alone_ms([
                (m, s) for m, s in outside
                if isinstance(m, (pnn.Hardswish, pnn.ReLU))]),
            "se_gate": alone_ms([(m, s) for m, s in shapes
                                 if isinstance(m, SqueezeExcitation)])}
        _PROFILE_S[0] += time.perf_counter() - t1
        _require(not any(port_launches().values()),
                 f"train-mobilenetv3 launched port kernels: "
                 f"{port_launches()}")
        del model, opt, step, x, y, stats0, shapes, outside
        gc.collect()
        torch.cuda.empty_cache()
        return {"model": "MobileNetV3-Large, bf16 parameters (float32 "
                         "masters in Momentum(0.1, 0.9)), float32 running "
                         "stats, Dropout(0.2) on a card generator, b 256 x "
                         "3 x 224 x 224 bf16, cross entropy in float32",
                "num_params": n_params, "init_s": init_s,
                "steps": warm + iters, "losses": losses,
                "step_ms": step_ms, "imgs_per_s": imgs_s,
                "mfu": imgs_s * 3 * fwd_flops / BF16_FLOPS_PER_S,
                "fwd_flops_per_img": fwd_flops,
                "peak_mem_allocated_gb": peak_alloc,
                "peak_mem_reserved_gb": peak_reserved,
                "nvidia_smi": smi,
                "step_profile": {
                    "device_ms": busy, "wall_ms": step_ms,
                    "idle_share": max(0.0, 1.0 - busy / step_ms)
                    if busy else None,
                    "device_ms_by_part": {k: v[1] for k, v in
                                          parts.items()},
                    "launches_by_part": {k: v[0] for k, v in
                                         parts.items()},
                    "pad_records_lost": lost,
                    "top_other": dict(sorted(other.items(),
                                             key=lambda kv: -kv[1])[:8])},
                "parts_alone": alone}

    _phase("train-mobilenetv3", train_mobilenetv3)

    # every family's ImageNet constructor at full width: (constructor,
    # arguments, batch,
    # picture size, Momentum's learning rate): 0.01 for VGG (its recipe)
    # and the stacks without BatchNorm (at 0.1 AlexNet, GoogLeNet and
    # LeNet diverge within three steps from Paddle's init), 0.1 else
    ZOO_FULL = (
        ("LeNet", {}, 256, 28, 0.01),
        ("alexnet", {}, 64, 224, 0.01),
        ("vgg16", {}, 64, 224, 0.01),
        ("vgg16", dict(batch_norm=True), 64, 224, 0.01),
        ("mobilenet_v1", {}, 64, 224, 0.1),
        ("mobilenet_v2", {}, 64, 224, 0.1),
        ("mobilenet_v3_small", {}, 64, 224, 0.1),
        ("squeezenet1_1", {}, 64, 224, 0.01),
        ("densenet121", {}, 64, 224, 0.1),
        ("googlenet", {}, 64, 224, 0.01),
        ("inception_v3", {}, 64, 299, 0.1),
        ("shufflenet_v2_x1_0", {}, 64, 224, 0.1),
        ("shufflenet_v2_swish", {}, 64, 224, 0.1),
    )

    def train_vision_zoo():
        """Every family's ImageNet constructor at full width
        (num_classes 1000, LeNet's 10 at b 256 x 1 x 28 x 28), bf16
        parameters with float32 masters in Momentum(lr, 0.9) (lr 0.01
        for VGG and the stacks without BatchNorm, 0.1 else: ZOO_FULL),
        float32
        running stats, Dropout on the model's card generator, b 64 x 3 x
        224 x 224 bf16 (InceptionV3 at 299 x 299) from RandomState(0),
        GoogLeNet's loss main + 0.3 x (aux1 + aux2): 1 warm and 2 timed
        TrainSteps. Losses finite, running stats moved where there are
        any, no port kernel launched. A line per model: parameters, step
        ms, imgs/s, MFU (3 x the forward FLOPs, over 989 TFLOP/s), peak
        memory."""
        reset_port_launches()
        rows = {}
        for name, kw, b, size, lr in ZOO_FULL:
            key = name + ("_bn" if kw.get("batch_norm") else "")
            t0 = time.perf_counter()
            nc = 10 if name == "LeNet" else 1000
            model = getattr(vision_models, name)(num_classes=nc, seed=0,
                                                 device="cuda", **kw)
            fwd_flops = _conv_fc_flops(torch, model, size)
            for p_ in model.parameters():
                p_.data = p_.data.to(torch.bfloat16)
            step = TrainStep(model, zoo_loss,
                             Momentum(learning_rate=lr, momentum=0.9,
                                      parameters=model.parameters()))
            rng = np.random.RandomState(0)
            c_in = 1 if name == "LeNet" else 3
            x = torch.as_tensor(
                rng.randn(b, c_in, size, size).astype(np.float32),
                device="cuda").to(torch.bfloat16)
            y = torch.as_tensor(rng.randint(0, nc, b).astype(np.int64),
                                device="cuda")
            stats0 = [b_.clone() for b_ in model.buffers()]
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            losses = [float(step(x, y))]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += [float(step(x, y)) for _ in range(2)]
            wall = time.perf_counter() - t0
            _require(all(np.isfinite(losses)),
                     f"train-vision-zoo {key}: losses {losses}")
            moved = sum(int(not torch.equal(a, b_)) for a, b_ in
                        zip(stats0, model.buffers()))
            _require(moved == len(stats0),
                     f"train-vision-zoo {key}: {len(stats0) - moved} of "
                     f"{len(stats0)} running stats did not move")
            imgs_s = b * 2 / wall
            rows[key] = {"num_params": model.num_params(), "batch": b,
                         "size": size, "lr": lr, "init_s": init_s,
                         "losses": losses,
                         "step_ms": wall * 1e3 / 2, "imgs_per_s": imgs_s,
                         "fwd_flops_per_img": fwd_flops,
                         "mfu": imgs_s * 3 * fwd_flops / BF16_FLOPS_PER_S,
                         "peak_mem_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                         "running_stats": len(stats0)}
            _emit({"train-vision-zoo": key, **rows[key]})
            del model, step, x, y, stats0
            gc.collect()
            torch.cuda.empty_cache()
        _require(not any(port_launches().values()),
                 f"train-vision-zoo launched port kernels: "
                 f"{port_launches()}")
        return {"models": rows, "nvidia_smi": smi}

    _phase("train-vision-zoo", train_vision_zoo)

    # -- training's tensor parallelism: the mp axis on one card ------------
    def mp_fleet(mp, device):
        """An mp-`mp` fleet mesh with every rank on `device`."""
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"mp_degree": mp}
        return fleet.init(is_collective=True, strategy=strategy,
                          devices=[device] * mp)

    def rel_max(got, want):
        """max |got - want| over max |want| (float64 on the CPU)."""
        got, want = got.detach().double().cpu(), want.detach().double().cpu()
        return float((got - want).abs().max()
                     / want.abs().max().clamp(min=1e-30))

    def tiny_tp_train_parity():
        """llama_tiny and gpt_tiny (float32, head_dim 64) with
        tensor_parallel at mp 2 on cuda:0 x 2 against the same weights at
        mp 1 on the CPU (carried by state_dict): logits, loss and every
        logical gradient within 1e-4 of the largest value, then 2 AdamW
        steps: both losses within 1e-5 relative and each weight's
        difference under 1e-2 of how far the steps moved it (over the
        elements whose gradient is not 0 but for rounding)."""
        out = {}
        reset_port_launches()
        for fam, mk, cls in (("llama", llama_tiny, LlamaForCausalLM),
                             ("gpt", gpt_tiny, GPTForCausalLM)):
            cfg = mk(hidden_size=256, tensor_parallel=True)
            cpu = cls(cfg, seed=3, device="cpu")
            mp_fleet(2, "cuda:0")
            try:
                card = cls(cfg, seed=11, device="cuda")
            finally:
                fleet._hcg = None
            card.load_state_dict(cpu.state_dict())
            ids = np.random.RandomState(7).randint(0, cfg.vocab_size,
                                                   (2, 96))
            start = {n: p.detach().clone()
                     for n, p in cpu.named_parameters()}
            res = {}
            for tag, m in (("cpu", cpu), ("card", card)):
                x = torch.as_tensor(ids, dtype=torch.int32,
                                    device="cpu" if tag == "cpu"
                                    else "cuda")
                m.zero_grad()
                logits = m(x)
                loss = m.loss(logits, x)
                loss.backward()
                grads = {n: p.grad.detach().cpu()
                         for n, p in m.named_parameters()}
                step = TrainStep(m, m.loss, AdamW(
                    learning_rate=1e-3, parameters=m.named_parameters()))
                losses = [float(step(x, x)) for _ in range(2)]
                res[tag] = (logits.detach().cpu(), float(loss), grads,
                            losses, {n: p.detach().cpu()
                                     for n, p in m.named_parameters()})
            (cl, closs, cg, csteps, cw), (gl, gloss, gg, gsteps, gw) = \
                res["cpu"], res["card"]
            shards = [n for n, _ in torch.nn.Module.named_parameters(card)
                      if "_mp" in n]
            _require(shards and all(
                s.device.type == "cuda"
                for s in card.shard_parameters()),
                f"tiny-tp-train-parity {fam}: shards {shards[:4]}")
            logit_err = rel_max(gl, cl)
            grad_err = {n: rel_max(gg[n], cg[n]) for n in cg}
            # an Adam step normalises each gradient, so one that is 0 but
            # for rounding (GPT's k bias: softmax ignores a shift of a
            # query's scores) moves by +-lr on either side at random:
            # weights are held where the CPU's grad passes 1e-5 of the
            # model's largest
            floor = 1e-5 * max(float(g.abs().max()) for g in cg.values())
            keep = {n: cg[n].abs() > floor for n in cw}
            moved = {n: float((gw[n] - cw[n])[keep[n]].norm()
                              / (cw[n] - start[n])[keep[n]].norm()
                              .clamp(min=1e-30)) for n in cw}
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip([gloss] + gsteps, [closs] + csteps))
            _require(logit_err < 1e-4 and max(grad_err.values()) < 1e-4,
                     f"tiny-tp-train-parity {fam}: logits {logit_err}, "
                     f"grads {grad_err}")
            _require(loss_rel < 1e-5 and max(moved.values()) < 1e-2,
                     f"tiny-tp-train-parity {fam}: losses card "
                     f"{[gloss] + gsteps} vs cpu {[closs] + csteps}, "
                     f"weights {moved}")
            out[fam] = {"loss_cpu": [closs] + csteps,
                        "loss_card": [gloss] + gsteps,
                        "loss_max_rel_diff": loss_rel,
                        "logits_rel_err": logit_err,
                        "grad_rel_err_max": max(grad_err.values()),
                        "weights_after_2_steps_rel_max": max(moved.values()),
                        "weights_not_held_zero_grad": {
                            n: int((~k_).sum()) for n, k_ in keep.items()
                            if not bool(k_.all())},
                        "logical_params": len(cg), "shards": len(shards)}
            del cpu, card, res
        launched = port_launches()
        _require(all(launched[k] > 0 for k in flash_counts()),
                 f"tiny-tp-train-parity launched {launched}")
        out["launches"] = launched
        return out

    _phase("tiny-tp-train-parity", tiny_tp_train_parity)
    gc.collect()
    torch.cuda.empty_cache()

    tp_train_launches = {}

    def train_tp_8b():
        """Llama-3-8B at its published widths, cut to 2 layers, bf16
        compute, tensor_parallel over an mp-4 mesh on cuda:0 x 4, b 1 x
        s 4096, AdamW + ClipGradByGlobalNorm(1.0) through TrainStep; the
        same seed's model at mp 1 beside it. The config also sets
        sequence_parallel, which Llama reads nowhere (as JAX's does not):
        the sequence-parallel linears and scatter_sequence run on no path
        of this phase. The first 3 steps' losses at mp 4 are held to mp
        1's within 1e-3 relative (measured gaps up to 8.9e-5), and so are
        ClipGradByGlobalNorm's global norms: within 1e-4 at step 1, where
        both models hold the same weights (measured 8.0e-6), and 5e-3 at
        steps 2 and 3, after two bf16 trajectories began to drift apart
        (measured 4.2e-4 and 1.22e-3)."""
        b, s, mp, L, warm = 1, 4096, 4, 2, 3
        tol, norm_tol = 1e-3, [1e-4, 5e-3, 5e-3]
        cfg = llama_3_8b(dtype="bfloat16", tensor_parallel=True,
                         sequence_parallel=True, num_hidden_layers=L)
        H, Q = cfg.num_attention_heads, cfg.hidden_size // \
            cfg.num_attention_heads
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(b, s)).astype(np.int32), device="cuda")
        steps, peaks, clips, norms = {}, {}, {}, {}

        def build(n):
            if n > 1:
                mp_fleet(n, "cuda:0")
            try:
                model = LlamaForCausalLM(cfg, seed=0, device="cuda")
            finally:
                fleet._hcg = None
            clips[n] = ClipGradByGlobalNorm(1.0)
            opt = AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                        weight_decay=0.01, grad_clip=clips[n])
            steps[n] = (model, TrainStep(model, model.loss, opt))

        def first_steps(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_port_launches()
            losses, norms[n] = [], []
            for _ in range(warm):
                losses.append(float(steps[n][1](ids, ids)))
                norms[n].append(float(clips[n].last_global_norm))
            peaks[n] = {"allocated_gb": torch.cuda.max_memory_allocated()
                        / 1e9,
                        "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
            launched = port_launches()
            per = L * n
            _require(flash_counts() == {k_: per * warm
                                        for k_ in flash_counts()},
                     f"mp {n}: {warm} steps launched {launched}, expected "
                     f"{per} of each flash kernel a step")
            _require(not any(v for k_, v in launched.items()
                             if k_ not in flash_counts()),
                     f"mp {n} training launched serving kernels: "
                     f"{launched}")
            return losses, launched

        t0 = time.perf_counter()
        build(mp)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        model4 = steps[mp][0]
        q0 = model4.model.layers[0].self_attn.q_proj
        shapes = [tuple(w.shape) for w in q0.shards("weight")]
        _require(shapes == [(4096, 1024)] * mp and not any(
            n_ == "weight" for n_ in q0._parameters),
            f"q_proj holds {shapes} and {list(q0._parameters)}")
        losses4, tp_launches_run = first_steps(mp)
        tp_train_launches.update(flash_counts())
        build(1)
        losses1, _ = first_steps(1)
        rel = [abs(a - b_) / abs(b_) for a, b_ in zip(losses4, losses1)]
        norm_rel = [abs(a - b_) / abs(b_)
                    for a, b_ in zip(norms[mp], norms[1])]
        _require(all(np.isfinite(losses4 + losses1 + norms[mp] + norms[1])),
                 f"non-finite loss or norm: mp 4 {losses4} {norms[mp]}, "
                 f"mp 1 {losses1} {norms[1]}")
        _require(max(rel) < tol, f"mp 4 losses {losses4} differ from mp 1 "
                                 f"{losses1} by {rel} (tolerance {tol})")
        _require(all(r < t for r, t in zip(norm_rel, norm_tol)),
                 f"mp 4 clip global norms {norms[mp]} differ from mp 1 "
                 f"{norms[1]} by {norm_rel} (tolerances {norm_tol})")
        alt = {1: [], mp: []}
        for _ in range(3):
            for n in (1, mp):
                reset_flash()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(2):
                    steps[n][1](ids, ids)
                torch.cuda.synchronize()
                alt[n].append((time.perf_counter() - t1) * 1e3 / 2)
                _require(flash_counts() == {k_: 2 * L * n
                                            for k_ in flash_counts()},
                         f"an alternated mp-{n} run launched "
                         f"{flash_counts()}")
        n_params = steps[1][0].num_params()
        fpt = 6 * n_params + 12 * L * H * Q * s

        def spread(xs):
            xs = sorted(xs)
            return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1],
                    "runs": xs}

        def profile(n):
            wall_ms = spread(alt[n])["median"]
            # a trace is whole once a pad was recorded (_kernel_events);
            # two more steps, with more pads, while none was
            for pads in (_PAD_LAUNCHES, 32768, 131072):
                prof = _device_breakdown(
                    torch, lambda: [steps[n][1](ids, ids) for _ in range(2)],
                    wall_ms * 2, pads)
                if prof["pad_records_lost"] is not None:
                    break
            _require(prof["pad_records_lost"] is not None,
                     f"train-tp-8b mp {n}: the profiler lost all {pads} pad "
                     f"records of a traced step")
            for k_ in ("device_ms", "device_kernels", "wall_ms"):
                prof[k_] /= 2
            for k_ in ("device_ms_by_family", "top_other"):
                prof[k_] = {a: v / 2 for a, v in prof[k_].items()}
            return prof

        profs = {f"mp{n}": profile(n) for n in (mp, 1)}
        # the row-parallel sums, measured apart at the step's shapes: each
        # layer's o_proj and down_proj sum 4 bf16 [1, 4096, 4096]
        # partials in float32 (forward and backward), the embedding 4
        # float32 ones
        from paddle_tpu_torch.distributed.collective import all_reduce

        def ar_ms(dtype):
            parts = [torch.randn(b, s, cfg.hidden_size, device="cuda",
                                 dtype=dtype).requires_grad_()
                     for _ in range(mp)]
            g = torch.randn(b, s, cfg.hidden_size, device="cuda",
                            dtype=dtype)
            return timer(lambda: torch.autograd.grad(
                all_reduce(parts)[0], parts, g))
        ar = {"bf16_partials_ms": ar_ms(torch.bfloat16),
              "f32_partials_ms": ar_ms(torch.float32),
              "per_step": {"bf16": 2 * L, "f32": 1}}
        ar_step = 2 * L * ar["bf16_partials_ms"] + ar["f32_partials_ms"]
        fams = dict(profs[f"mp{mp}"]["device_ms_by_family"])
        flash_ms = sum(v for f_, v in fams.items() if f_.startswith("flash"))
        by_family = {"flash": flash_ms,
                     "gemm": fams.get("library_gemm", 0.0),
                     "all_reduce_copies_and_sums": ar_step,
                     "other": fams.get("other", 0.0) - ar_step}
        for n in (mp, 1):
            fl = profs[f"mp{n}"]["flash_kernels"]
            traced = {k_: v[0] for k_, v in fl.items() if "_kernel<" in k_}
            want = {f"flash_wg::{k_}_kernel<bf16,128>": 2 * L * n
                    for k_ in ("fwd", "dq", "dkv")}
            _require(traced == want,
                     f"mp {n}: the traced steps ran {fl}, not {want}")
        del steps, model4, q0
        gc.collect()
        torch.cuda.empty_cache()
        return {"model": "Llama-3-8B widths (hidden 4096, 32 / 8 heads of "
                         "128, intermediate 14336, vocab 128256), 2 of 32 "
                         "layers, bf16 compute, b1 x s4096, AdamW(3e-4, "
                         "wd 0.01) + ClipGradByGlobalNorm(1.0), "
                         "tensor_parallel (sequence_parallel set, read by "
                         "nothing), mp 4 on cuda:0 x 4 beside mp 1",
                "num_params": n_params, "init_s_mp4": init_s,
                "losses": {"mp4": losses4, "mp1": losses1,
                           "rel_diff": rel, "tolerance": tol},
                "clip_global_norms": {"mp4": norms[mp], "mp1": norms[1],
                                      "rel_diff": norm_rel,
                                      "tolerance": norm_tol},
                "q_proj_shards": shapes,
                "launches_per_step": {
                    k_: v // warm for k_, v in tp_train_launches.items()},
                "launches_first_steps_mp4": tp_launches_run,
                "alternated_step_ms": {f"mp{n}": spread(v)
                                       for n, v in alt.items()},
                "tokens_per_s": {f"mp{n}": b * s / (spread(v)["median"]
                                                   / 1e3)
                                 for n, v in alt.items()},
                "mfu": {f"mp{n}": b * s / (spread(v)["median"] / 1e3) * fpt
                        / BF16_FLOPS_PER_S for n, v in alt.items()},
                "flops_per_token": fpt,
                "mp4_over_mp1_step": spread(alt[mp])["median"]
                / spread(alt[1])["median"],
                "device_ms_by_family_mp4": by_family,
                "all_reduce_measured_apart": ar,
                "peak_mem": {f"mp{n}": v for n, v in peaks.items()},
                "peak_mem_note": "mp 1's peak holds mp 4's model resident",
                "nvidia_smi": smi, "step_profile": profs}

    _phase("train-tp-8b", train_tp_8b)
    gc.collect()
    torch.cuda.empty_cache()

    def cpu_and_card(cfg, num_blocks=64, cls=None):
        """A seeded int4 decoder (``cls``, default PagedLlamaDecoder) on
        the CPU and the same weights on the card (``num_blocks`` blocks
        of 8)."""
        cls = cls or PagedLlamaDecoder
        cpu = cls.from_config(cfg, seed=3, weight_dtype="int4",
                              num_blocks=num_blocks, block_size=8,
                              device="cpu")

        def to_cuda(w):
            if isinstance(w, QWeight):
                return QWeight(w.q.cuda(), w.scale.cuda(), w.kind)
            return w.cuda()

        tree = cpu.weights[0]
        weights = {k: ([{kk: to_cuda(vv) for kk, vv in lw.items()}
                        for lw in v] if k == "layers" else to_cuda(v))
                   for k, v in tree.items()}
        gpu = cls(cfg, weights, weight_dtype="int4", num_blocks=num_blocks,
                  block_size=8, device="cuda")
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
        dmm.launches_by_shape.clear()
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

    def tiny_prefix_parity():
        """Prefix caching on both schedulers, llama_tiny float32 with int4
        weights: the card (its programs CUDA graphs) with caching on,
        the card with it off and the CPU with it on give the same
        greedy tokens, and the card and the CPU the same hit tokens. At
        head_dim 64, which the dense prefill's flash kernel takes."""
        cfg_t = llama_tiny(hidden_size=256)
        cpu, gpu = cpu_and_card(cfg_t)
        trng = np.random.RandomState(7)
        head = trng.randint(0, cfg_t.vocab_size, 24)       # 3 blocks of 8
        ps = [np.concatenate([head, trng.randint(0, cfg_t.vocab_size, n)])
              for n in (3, 9, 5, 7)]
        ps.append(trng.randint(0, cfg_t.vocab_size, 21))
        info = {}
        for ragged in (True, False):
            res = {}
            for name, dec, pc in (("cpu", cpu, True), ("card", gpu, True),
                                  ("card_off", gpu, False)):
                eng = ServingEngine(dec, ragged=ragged, max_batch_size=3,
                                    chunk_size=4, prefill_chunk=8,
                                    prompt_buckets=(8, 16, 32, 64),
                                    prefix_caching=pc)
                rids = [eng.add_request(p, SamplingParams(max_new_tokens=6))
                        for p in ps]
                eng.run_to_completion()
                res[name] = ([eng.result(r).tolist() for r in rids],
                             eng.stats()["prefix_cache_hit_tokens"])
                eng.close()
                dec.cache.debug_check()
            kind = "ragged" if ragged else "dense"
            _require(res["card"][0] == res["card_off"][0] == res["cpu"][0],
                     f"tiny-prefix-parity {kind}: tokens differ: {res}")
            _require(res["card"][1] == res["cpu"][1] > 0
                     and res["card_off"][1] == 0,
                     f"tiny-prefix-parity {kind}: hit tokens {res}")
            info[kind] = {"hit_tokens": res["card"][1], "tokens_equal": True}
        return info

    _phase("tiny-prefix-parity", tiny_prefix_parity)

    def rich_specs(ps, vocab, new):
        """The rich mix on prompts ps[0..5]: greedy; temperature 0.8
        with top_k 40 and top_p 0.9; repetition penalty 1.3 (greedy); a
        25% allowed mask (greedy); top_k 1 at temperature 5 and top_p
        1e-9 at temperature 3, each beside a greedy twin on its prompt.
        Returns (specs [(prompt, SamplingParams kwargs)], the mask)."""
        mask = np.random.RandomState(12).rand(vocab) < 0.25
        kws = [dict(), dict(temperature=0.8, top_k=40, top_p=0.9),
               dict(repetition_penalty=1.3), dict(allowed_tokens=mask),
               dict(temperature=5.0, top_k=1), dict(),
               dict(temperature=3.0, top_p=1e-9), dict()]
        order = [0, 1, 2, 3, 4, 4, 5, 5]
        return ([(ps[i], dict(kw, max_new_tokens=new))
                 for i, kw in zip(order, kws)], mask)

    def check_rich(outs, mask, where, gap=None):
        """The rich mix's own gates: the masked stream inside its mask,
        and each twin equal to its greedy twin; with ``gap`` (8B, whose
        bf16 logits tie exactly at times: top_k 1 and top_p 1e-9 keep
        every token tied at the maximum, and the draw picks among them,
        where the argmax takes the first) a twin may also leave its
        greedy twin where ``gap(i, a, b)`` finds a near-tie. Returns the
        first divergences."""
        _require(bool(mask[np.asarray(outs[3])].all()),
                 f"{where}: the masked stream left its mask: {outs[3]}")
        found = []
        for i in (4, 6):
            if np.array_equal(outs[i], outs[i + 1]):
                continue
            g = gap(i, outs[i], outs[i + 1]) if gap else None
            _require(g is not None and abs(g[1]) <= 2 * g[2],
                     f"{where}: twin {i} leaves its greedy twin at (token, "
                     f"gap, noise) {g}: {list(outs[i])} vs "
                     f"{list(outs[i + 1])}")
            found.append((i, g))
        return found

    def tiny_rich_faults_parity():
        """JAX's key stream and fault tolerance on the card against the
        CPU: the threefry known answer; the bits and uniforms of an
        [8, 128256] draw equal on card and CPU, the Gumbel noise within
        2e-6; both engines on the rich mix give the CPU's streams; and a
        preemption-and-recompute run (optimistic admission on 14 blocks
        of 8) gives the roomy run's greedy streams, on the card and the
        CPU. llama_tiny(hidden_size=256) float32 with int4 weights."""
        z = torch.zeros((), dtype=torch.int64, device="cuda")
        zc = torch.zeros(1, dtype=torch.int64, device="cuda")
        a, b = prng._threefry_torch(z, z, zc, zc)
        kat = [int(a[0]), int(b[0])]
        host = [int(x) for x in prng.threefry_2x32(np.zeros(2, np.uint32),
                                                   np.zeros(2, np.uint32))]
        _require(kat == host == [0x6B200159, 0x99BA4EFE],
                 f"threefry known answer: card {kat}, host {host}")
        key = prng.PRNGKey(1234)
        shape = (8, 128256)
        tiny_f = float(np.finfo(np.float32).tiny)
        bits = [prng.random_bits(key, shape, device=d).cpu()
                for d in ("cuda", "cpu")]
        _require(torch.equal(bits[0], bits[1]),
                 "the card's threefry bits differ from the CPU's")
        unif = [prng.uniform(key, shape, tiny_f, 1.0, device=d).cpu()
                for d in ("cuda", "cpu")]
        _require(torch.equal(unif[0], unif[1]),
                 "the card's uniforms differ from the CPU's")
        gum = [prng.gumbel(key, shape, device=d).cpu()
               for d in ("cuda", "cpu")]
        gerr = float((gum[0] - gum[1]).abs().max())
        _require(gerr <= 2e-6, f"Gumbel noise card vs CPU {gerr}")
        cfg_t = llama_tiny(hidden_size=256)
        cpu, gpu = cpu_and_card(cfg_t)
        rng = np.random.RandomState(9)
        ps = [rng.randint(0, cfg_t.vocab_size, int(n))
              for n in rng.randint(5, 30, 6)]
        specs, mask = rich_specs(ps, cfg_t.vocab_size, 10)
        info = {"threefry_known_answer": [hex(x) for x in kat],
                "bits_8x128256_equal": True, "uniform_equal": True,
                "gumbel_max_abs_err": gerr}
        reset_dense()
        for ragged in (True, False):
            res = {}
            for name, dec in (("cpu", cpu), ("card", gpu)):
                eng = ServingEngine(dec, ragged=ragged, max_batch_size=4,
                                    chunk_size=4, prefill_chunk=8, seed=3,
                                    prompt_buckets=(8, 16, 32))
                rids = [eng.add_request(p, SamplingParams(**kw))
                        for p, kw in specs]
                eng.run_to_completion()
                st = eng.stats()
                _clean_run(st, f"tiny rich mix {name}: "
                               f"{[eng.request(r).error for r in rids]}")
                _require(st["finished"] == len(specs),
                         f"tiny rich mix {name}: {st['finished']} finished")
                res[name] = [eng.result(r) for r in rids]
                eng.close()
                dec.cache.debug_check()
            kind = "ragged" if ragged else "dense"
            _require(all(np.array_equal(x, y)
                         for x, y in zip(res["card"], res["cpu"])),
                     f"tiny rich mix ({kind}): card and CPU streams differ: "
                     f"{res}")
            check_rich(res["card"], mask, f"tiny rich mix ({kind})")
            info[f"rich_{kind}_tokens_equal"] = True
        launched = dense_counts()
        _require(all(launched[k] > 0 for k in launched),
                 f"tiny-rich-faults-parity launched {launched}")
        info["launches"] = launched
        # preemption with recompute: a tight pool against a roomy one
        prng_ = np.random.RandomState(3)
        pre_ps = [prng_.randint(0, cfg_t.vocab_size, n) for n in (9, 14, 7)]
        tight = cpu_and_card(cfg_t, num_blocks=14)
        for ragged in (True, False):
            res = {}
            for name, dec, adm in (("card", gpu, "worst_case"),
                                   ("card_tight", tight[1], "optimistic"),
                                   ("cpu_tight", tight[0], "optimistic")):
                eng = ServingEngine(dec, ragged=ragged, max_batch_size=3,
                                    chunk_size=4, prefill_chunk=8,
                                    prompt_buckets=(16, 32), admission=adm)
                rids = [eng.add_request(p, SamplingParams(max_new_tokens=40))
                        for p in pre_ps]
                while eng.step():
                    dec.cache.debug_check()
                st = eng.stats()
                _clean_run(st, f"tiny preemption {name}")
                _require(st["finished"] == 3,
                         f"tiny preemption {name}: {st['finished']} finished")
                res[name] = ([eng.result(r).tolist() for r in rids],
                             st["preemptions"])
                eng.close()
            kind = "ragged" if ragged else "dense"
            _require(res["card_tight"][1] >= 1
                     and res["card_tight"][1] == res["cpu_tight"][1],
                     f"tiny preemption ({kind}): preemptions "
                     f"{res['card_tight'][1]} card, {res['cpu_tight'][1]} "
                     f"CPU")
            _require(res["card_tight"][0] == res["card"][0]
                     == res["cpu_tight"][0],
                     f"tiny preemption ({kind}): the recomputed streams "
                     f"differ from the clean run: {res}")
            info[f"preemption_{kind}"] = {
                "preemptions": res["card_tight"][1], "tokens_equal": True}
        return info

    _phase("tiny-rich-faults-parity", tiny_rich_faults_parity)

    # -- the main path: 8B int4 serving --------------------------------------
    cfg = llama_3_8b(dtype="bfloat16")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, int(n))
               for n in rng.randint(100, 601, 8)]
    temps = [0.0] * 6 + [0.8] * 2

    def engine(dec, ragged, seed=0, graphs=False, prefix_caching=True,
               **kw):
        """The smoke's engine on dec: max batch 8, chunks of 8, prefill
        chunk 256; the ragged engine takes prompts up to 1024 and pure
        prefill chunks of 256 rows; eager unless ``graphs``; ``kw`` go
        to the engine (admission, retries)."""
        if ragged:
            kw["prompt_buckets"] = (32, 64, 128, 256, 512, 1024)
        return ServingEngine(dec, ragged=ragged, max_batch_size=8,
                             prefill_chunk=256, chunk_size=8, seed=seed,
                             prefix_caching=prefix_caching,
                             cuda_graphs=graphs, **kw)

    def serve(dec, n_req, seed=0, ragged=True, reqs=None,
              prefix_caching=True, new=32):
        """Serve n_req requests (serve-int4's prompts unless given) with
        ``new`` new tokens each through a fresh eager engine on dec:
        (tokens, wall seconds, stats)."""
        eng = engine(dec, ragged, seed=seed, prefix_caching=prefix_caching)
        reqs = reqs or list(zip(prompts[:n_req], temps[-n_req:]))
        rids = [eng.add_request(p, SamplingParams(**t) if isinstance(t, dict)
                                else SamplingParams(max_new_tokens=new,
                                                    temperature=t))
                for p, t in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        outs = [eng.result(r) for r in rids]
        errors = [eng.request(r).error for r in rids]
        eng.close()
        _clean_run(st, f"serve ({'ragged' if ragged else 'dense'}): "
                       f"{errors}")
        _require(st["finished"] == n_req, f"only {st['finished']} of "
                                          f"{n_req} requests finished")
        for o in outs:
            _require(len(o) == new and o.min() >= 0
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
        args = (torch.randint(0, dec.cfg.vocab_size, (w,), generator=gen,
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
            for lw in dec.weights[0]["layers"] for w in lw.values()) \
            + dec.weights[0]["head"].q.numel()
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
        args = (torch.randint(0, dec.cfg.vocab_size, (b,), generator=gen,
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

    def engines_alternated(dec, reqs, reps=2):
        """Both engines on the same requests, run alternately (ragged,
        dense, ragged, ...) reps times each, then their decode steps at
        8 rows and ctx 512 alternately reps times each: per engine, each
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
        for _ in range(reps):
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

    def dense_requests(vocab=cfg.vocab_size):
        """serve-dense-int4's 8 requests: (prompt of 100..512 tokens of a
        vocabulary of ``vocab``, temperature), 6 greedy and 2 at 0.8."""
        drng = np.random.RandomState(1)
        return list(zip([drng.randint(0, vocab, int(n))
                         for n in drng.randint(100, 513, 8)], temps))

    def serve_dense_int4():
        """THE DENSE PATH: serve-int4's decoder (a decoder reused across
        engines keeps its scratch page) behind ServingEngine(ragged=
        False), then generate()."""
        dec = shared["dec"]
        reqs = dense_requests()
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
        shared["dense_reqs"] = reqs
        return info

    _phase("serve-dense-int4", serve_dense_int4)

    # -- prefix caching and CUDA graphs on the 8B decoder --------------------
    # 8 requests sharing a 384-token prefix (6 blocks of 64), each with
    # 64..128 tokens of its own, so every prompt fits the dense engine's
    # 512 bucket: a system prompt or few-shot template. In one admission
    # wave the first writes the prefix and the other seven splice it.
    pfx_rng = np.random.RandomState(8)
    head = pfx_rng.randint(0, cfg.vocab_size, 384)
    prefix_reqs = [(np.concatenate([head, pfx_rng.randint(0, cfg.vocab_size,
                                                       int(n))]), 0.0)
                   for n in pfx_rng.randint(64, 129, 8)]
    prefix_hits = 7 * 6 * 64

    def last_logits(dec, toks, rows):
        """The card's float32 logits after ``toks``: ragged prefill
        ministeps of ``rows`` rows each over a fresh allocation."""
        cache, n, dev = dec.cache, len(toks), dec.device
        cache.allocate(10_000, n)
        slots = torch.as_tensor([cache.extend(10_000) for _ in range(n)],
                                dtype=torch.int32, device=dev)
        table = torch.as_tensor(cache.block_table(10_000, dec.max_pages)[None],
                                device=dev)
        ids = torch.as_tensor(toks, dtype=torch.int32, device=dev)
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            for s0 in range(0, n, rows):
                sl = slice(s0, min(n, s0 + rows))
                lg, _, _ = dec._ragged_logits(
                    dec.weights, cache.k, cache.v, ids[sl], pos[sl],
                    slots[sl], torch.zeros_like(pos[sl]), pos[sl] + 1, table)
        cache.free(10_000)
        return lg[-1].float()

    def first_gap(dec, prompt, a, b):
        """At the first divergence of two greedy streams: (index, the
        card's logit gap between a's and b's token there, the logit noise
        there). The logits come from one prefill ministep over the prompt
        and a's tokens before the divergence (layer products of more
        than 32 rows on cuBLAS); the noise is their largest difference
        from the same logits computed in ministeps of 32 rows (products
        on the GEMV kernel), two computations of one function. None when
        the streams agree. Caching on and off differ in the same way
        (where a prompt's rows run), so a divergence must be a near-tie:
        a gap of at most twice the noise."""
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            return None
        toks = np.concatenate([prompt, a[:i]]).astype(np.int32)
        one = last_logits(dec, toks, len(toks))
        rows32 = last_logits(dec, toks, 32)
        return (i, float(one[int(a[i])] - one[int(b[i])]),
                float((one - rows32).abs().max()))

    def serve_prefix_int4():
        """Both engines on the shared-prefix requests (greedy, 32 new
        tokens), caching on against off: hit tokens, streams (equal, or
        a near-tie at the first divergence), TTFT, and the prefill's
        device ms (the same requests with one new token, profiled)."""
        dec = shared["dec"]
        info, outs_on = {}, {}
        for name, ragged in (("ragged", True), ("dense", False)):
            runs = {}
            for pc in (True, False):
                outs, wall, st = serve(dec, 8, ragged=ragged,
                                       reqs=prefix_reqs, prefix_caching=pc)
                _, pwall, _ = serve(dec, 8, ragged=ragged, reqs=prefix_reqs,
                                    prefix_caching=pc, new=1)
                prof = _device_breakdown(
                    torch, lambda: serve(dec, 8, ragged=ragged,
                                         reqs=prefix_reqs,
                                         prefix_caching=pc, new=1),
                    pwall * 1e3)
                runs[pc] = {"outs": outs,
                            "hit_tokens": st["prefix_cache_hit_tokens"],
                            "hit_rate": st["prefix_cache_hit_rate"],
                            "tok_per_s": st["generated_tokens"] / wall,
                            "ttft_p50_s": st["ttft_p50_s"],
                            "itl_p50_s": st["itl_p50_s"],
                            "prefill_wall_ms": pwall * 1e3,
                            "prefill_device_ms": prof["device_ms"],
                            "prefill_device_ms_by_family":
                                prof["device_ms_by_family"]}
            _require(runs[True]["hit_tokens"] == prefix_hits
                     and runs[False]["hit_tokens"] == 0,
                     f"{name}: hit tokens {runs[True]['hit_tokens']} "
                     f"(caching off {runs[False]['hit_tokens']}), expected "
                     f"{prefix_hits}")
            gaps = []
            for (p, _), a, b in zip(prefix_reqs, runs[True]["outs"],
                                    runs[False]["outs"]):
                g = first_gap(dec, p, a, b)
                _require(g is None or abs(g[1]) <= 2 * g[2],
                         f"{name}: caching on and off diverge at (token, "
                         f"logit gap, noise) {g}, beyond a near-tie")
                gaps.append(g)
            outs_on[name] = [o.tolist() for o in runs[True]["outs"]]
            info[name] = {
                "first_divergences": gaps,
                **{f"{k}_{'on' if pc else 'off'}": v
                   for pc, r in runs.items() for k, v in r.items()
                   if k != "outs"}}
        shared["prefix_outs"] = outs_on
        return info

    _phase("serve-prefix-int4", serve_prefix_int4)

    def graph_launches(dispatches, L):
        """The launches a run's program dispatches call for, under the
        eager gates: a ragged ministep 32 attention and, at W <= 32, 129
        GEMV; a dense decode step 32 paged-decode and 129 GEMV; a
        _prefill_impl dispatch (plain final, mid at offset 0) 32 flash
        forward; a prefill of <= 32 token rows its 128 layer products on
        the GEMV, a final its head product too."""
        exp = {"paged_attention_decode": 0, "ragged_paged_attention": 0,
               "decode_matmul": 0, "flash_fwd": 0}
        for (fam, key), n in dispatches.items():
            if fam.startswith(("ragged", "spec")):
                # every ragged family's key leads with (T, W), a verify
                # ministep's with W
                T, W = key[:2] if fam.startswith("ragged") else (1, key[0])
                exp["ragged_paged_attention"] += n * L * T
                exp["decode_matmul"] += n * T * (4 * L + 1) * (W <= 32)
            elif fam == "decode":
                exp["paged_attention_decode"] += n * L * key[0]
                exp["decode_matmul"] += n * (4 * L + 1) * key[0]
            elif fam in ("prefill", "prefill_prefix"):
                b, w = key[:2]
                exp["flash_fwd"] += n * L * (fam == "prefill")
                exp["decode_matmul"] += n * (4 * L * (w * b <= 32) + 1)
            else:                          # prefill_mid0, prefill_mid
                exp["flash_fwd"] += n * L * (fam == "prefill_mid0")
                exp["decode_matmul"] += n * 4 * L * (key[0] <= 32)
        return exp

    def drive(eng, reqs):
        """Serve reqs (32 new tokens each; (prompt, temperature) or
        (prompt, SamplingParams kwargs)) through a live engine: (tokens,
        wall seconds, stats); then its finished requests and prefix
        cache are cleared for the next run."""
        rids = [eng.add_request(p, SamplingParams(**t) if isinstance(t, dict)
                                else SamplingParams(max_new_tokens=32,
                                                    temperature=t))
                for p, t in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        outs = [eng.result(r) for r in rids]
        _clean_run(st, f"drive: {[eng.request(r).error for r in rids]}")
        _require(st["finished"] == len(reqs),
                 f"drive: {st['finished']} of {len(reqs)} finished")
        eng.clear_finished()
        eng.dec.cache.clear_prefix_cache()
        eng.dec.cache.debug_check()
        return outs, wall, st

    def chunk_case(dec, ragged, sb, ctx=512, T=8, mb=8):
        """The operands of one decode chunk (T 8) of 8 sequences at ctx
        512 on real pages (allocated here): (family, the operands of a
        greedy plain chunk, the sequence ids to free). ``flavour``
        turns them into a sampled or rich chunk's (key, operands)."""
        cache, mp = dec.cache, dec.max_pages
        sids = list(range(3000, 3000 + mb))
        for sid in sids:
            cache.allocate(sid, ctx + T)
            for _ in range(ctx):
                cache.extend(sid)
        toks = np.random.RandomState(4).randint(0, cfg.vocab_size, mb) \
            .astype(np.int32)
        keys = prng.split(prng.PRNGKey(4), T).view(np.int32)
        if ragged:
            sched = np.zeros((6, T, mb), np.int32)
            tables = np.full((mb + 1, mp), sb, np.int32)
            for c, sid in enumerate(sids):
                for t in range(T):
                    pos = cache.context_len(sid)
                    sched[1:, t, c] = (pos, cache.extend(sid), c, pos + 1, 1)
                tables[c] = cache.block_table(sid, mp)
            return "ragged", [toks, sched, tables,
                              np.zeros((T, mb), np.float32), keys], sids
        tables = np.full((T, mb, mp), sb, np.int32)
        ctx_a = np.zeros((T, mb), np.int32)
        slots = np.zeros((T, mb), np.int32)
        for c, sid in enumerate(sids):
            for t in range(T):
                ctx_a[t, c] = cache.context_len(sid)
                slots[t, c] = cache.extend(sid)
            tables[:, c] = cache.block_table(sid, mp)[None]
        zeros = np.zeros(mb, np.int32)
        return "decode", [tables, ctx_a, slots, zeros, toks,
                          np.ones(mb, np.int32), np.zeros(mb, np.float32),
                          keys], sids

    def flavour(fam, arrays, sampled, rich, T=8, mb=8):
        """(key, operands) of chunk_case's chunk, greedy or sampled at
        temperature 0.8, plain or rich (top_k 40, top_p 0.9, repetition
        penalty 1.3 in every column)."""
        arrays = list(arrays)
        shape = (T, mb) if fam == "ragged" else (mb,)
        if sampled:
            i = 3 if fam == "ragged" else 6
            arrays[i] = np.full(shape, 0.8, np.float32)
        if rich:
            arrays += [np.full(shape, 40, np.int32),
                       np.full(shape, 0.9, np.float32),
                       np.full(shape, 1.3, np.float32)]
            if fam == "ragged":
                arrays.append(np.ones(mb, np.int32))
        key = (T, mb, sampled, rich) if fam == "ragged" \
            else (T, sampled, rich)
        return key, arrays

    def chunk_programs(dec, ragged, ctx=512):
        """One decode chunk (T 8) of 8 sequences at ctx 512 on real pages
        through an eager engine's program and a CUDA graph of it,
        alternated 3 times each: wall ms a step (chunk wall / 8), the
        launches of one chunk; the graph's device ms and idle share a
        step (the eager step's: serve-int4 / serve-dense-int4)."""
        T, mb = 8, 8
        engs = {g: engine(dec, ragged, graphs=g) for g in (False, True)}
        cache = dec.cache
        fam, base, sids = chunk_case(dec, ragged, engs[True]._scratch_block,
                                     ctx)
        key, arrays = flavour(fam, base, False, False)
        out = {}
        with torch.inference_mode():
            for g, eng in engs.items():
                eng.programs.run(fam, key, arrays)       # compile / capture
                torch.cuda.synchronize()
                reset_dense()
                eng.programs.run(fam, key, arrays)
                torch.cuda.synchronize()
                out[g] = {"launches": dense_counts(), "wall_ms": []}
            n = 5
            for _ in range(3):
                for g, eng in engs.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        eng.programs.run(fam, key, arrays)
                    torch.cuda.synchronize()
                    out[g]["wall_ms"].append(
                        (time.perf_counter() - t0) * 1e3 / (n * T))
            for g in engs:
                out[g].update(step_wall_ms_median=float(np.median(
                                  out[g]["wall_ms"])),
                              step_wall_ms_min=min(out[g]["wall_ms"]),
                              step_wall_ms_max=max(out[g]["wall_ms"]))
            med = out[True]["step_wall_ms_median"]
            prof = _device_breakdown(
                torch, lambda: [engs[True].programs.run(fam, key, arrays)
                                for _ in range(n)], med * n * T)
            out[True].update(step_device_ms=prof["device_ms"] / (n * T),
                             idle_share=prof["idle_share"])
        for eng in engs.values():
            eng.close()
        for sid in sids:
            cache.free(sid)
        want = {"paged_attention_decode": 0 if ragged else 32 * T,
                "ragged_paged_attention": 32 * T if ragged else 0,
                "decode_matmul": 129 * T, "flash_fwd": 0}
        for g in (False, True):
            _require(out[g]["launches"] == want,
                     f"a {'graph' if g else 'eager'} {fam} chunk launched "
                     f"{out[g]['launches']}, expected {want}")
        return {"eager": out[False], "graph": out[True]}

    def serve_graphs():
        """Both 8B engines with warmup_programs + seal_programs, then
        serve-dense-int4's requests: tokens equal a fresh eager engine's
        (stochastic rows included), no unexpected recompile, launches
        equal to what the dispatches call for; the shared-prefix
        requests equal serve-prefix-int4's with 2688 hit tokens; then
        eager and graph runs alternated, 2 each; one graph run's idle
        share; and the decode chunk at ctx 512 eager against graph.
        One alternated round of each (two until the smoke's time had to
        make room for the tp training phases)."""
        dec = shared["dec"]
        reqs = shared["dense_reqs"]
        L = cfg.num_hidden_layers
        info = {}
        shared["graph_engines"], shared["capture"] = {}, {}
        for name, ragged in (("ragged", True), ("dense", False)):
            eng = engine(dec, ragged, graphs=True)
            free0 = dec.cache.free_blocks
            # memory the graphs keep: reserved after emptying the cache,
            # before and after (each capture empties it too)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            eng.warmup_programs()
            eng.seal_programs()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            torch.cuda.empty_cache()
            capture = {"graphs": eng.programs.captured, "seconds": secs,
                       "pool_gb": (torch.cuda.memory_reserved() - mem0)
                       / 1e9}
            _require(dec.cache.free_blocks == free0,
                     f"{name}: warmup_programs claimed pool blocks")
            reset_dense()
            eng.programs.dispatches.clear()
            g_outs, g_wall, g_st = drive(eng, reqs)
            launched = dense_counts()
            n_disp = sum(eng.programs.dispatches.values())
            expect = graph_launches(eng.programs.dispatches, L)
            _require(launched == expect,
                     f"{name} graphs launched {launched}, the dispatches "
                     f"{dict(eng.programs.dispatches)} call for {expect}")
            _require(g_st["unexpected_recompiles"] == 0,
                     f"{name}: {g_st['unexpected_recompiles']} unexpected "
                     f"recompiles after seal_programs")
            e_outs, e_wall, e_st = serve(dec, 8, ragged=ragged, reqs=reqs)
            for i, (a, b) in enumerate(zip(g_outs, e_outs)):
                _require(np.array_equal(a, b),
                         f"{name} request {i} (temperature {reqs[i][1]}) "
                         f"differs between graphs and eager")
            p_outs, _, p_st = drive(eng, prefix_reqs)
            _require([o.tolist() for o in p_outs]
                     == shared["prefix_outs"][name]
                     and p_st["prefix_cache_hit_tokens"] == prefix_hits
                     and p_st["unexpected_recompiles"] == 0,
                     f"{name}: the shared-prefix requests under graphs "
                     f"differ from eager, or hit "
                     f"{p_st['prefix_cache_hit_tokens']} tokens, or "
                     f"recompiled {p_st['unexpected_recompiles']}")
            runs = {"eager": [], "graph": []}
            for _ in range(1):          # one round: the smoke's time budget
                for mode in runs:
                    if mode == "eager":
                        _, wall, st = serve(dec, 8, ragged=ragged, reqs=reqs)
                    else:
                        _, wall, st = drive(eng, reqs)
                    runs[mode].append({
                        "tok_per_s": st["generated_tokens"] / wall,
                        "ttft_p50_s": st["ttft_p50_s"],
                        "itl_p50_s": st["itl_p50_s"],
                        "itl_p99_s": st["itl_p99_s"]})
            med_wall = float(np.median([256 / r["tok_per_s"]
                                        for r in runs["graph"]]))
            prof = _device_breakdown(torch, lambda: drive(eng, reqs),
                                     med_wall * 1e3)
            # the sealed engine serves the rich and fault phases next
            shared["graph_engines"][name] = eng
            shared["capture"][name] = capture

            def spread(xs):
                return {"runs": xs, "median": float(np.median(xs)),
                        "min": min(xs), "max": max(xs)}

            info[name] = {
                "capture": capture, "launches_per_run": launched,
                "program_dispatches_per_run": n_disp,
                "unexpected_recompiles": g_st["unexpected_recompiles"],
                "alternated": {mode: {k: spread([r[k] for r in rs])
                                      for k in rs[0]}
                               for mode, rs in runs.items()},
                "graph_run_idle_share": prof["idle_share"],
                "graph_run_device_ms": prof["device_ms"],
                "graph_run_wall_ms": med_wall * 1e3,
                "chunk_ctx512": chunk_programs(dec, ragged)}
        return info

    _phase("serve-graphs", serve_graphs)

    def the_dec():
        """serve-int4's 8B decoder (built here when that phase did not
        run)."""
        if "dec" not in shared:
            shared["dec"] = PagedLlamaDecoder.from_config(
                cfg, seed=0, weight_dtype="int4", block_size=64,
                num_blocks=160, device="cuda")
        return shared["dec"]

    def sealed_engine(name):
        """serve-graphs' engine (worst-case admission, every program a
        graph, the set sealed), captured here when that phase did not
        run."""
        engs = shared.setdefault("graph_engines", {})
        if name not in engs:
            eng = engine(the_dec(), name == "ragged", graphs=True)
            t0 = time.perf_counter()
            eng.warmup_programs()
            eng.seal_programs()
            torch.cuda.synchronize()
            shared.setdefault("capture", {})[name] = {
                "graphs": eng.programs.captured,
                "seconds": time.perf_counter() - t0}
            engs[name] = eng
        return engs[name]

    def path_kernels(ragged):
        return (("ragged_paged_attention", "decode_matmul") if ragged else
                ("paged_attention_decode", "flash_fwd", "decode_matmul"))

    def sampler_costs(rows):
        """Device ms (the timer's mean) of the sampler's parts over
        float32 logits [rows, 128256]: the threefry bits with the
        Gumbel transform, the descending sort, the whole plain and rich
        samplers (temperature 0.8; top_k 40, top_p 0.9, repetition
        penalty 1.3), and the greedy argmax."""
        V = cfg.vocab_size
        lg = torch.randn(rows, V, device="cuda", generator=gen) * 3
        temp = torch.full((rows,), 0.8, device="cuda")
        tk = torch.full((rows,), 40, dtype=torch.int32, device="cuda")
        tp = torch.full((rows,), 0.9, device="cuda")
        rp = torch.full((rows,), 1.3, device="cuda")
        seen = torch.rand(rows, V, device="cuda", generator=gen) < 0.01
        allowed = torch.ones(rows, V, dtype=torch.bool, device="cuda")
        key = torch.as_tensor(prng.PRNGKey(5).view(np.int32), device="cuda")

        class Plain:
            top_k = 0

        with torch.inference_mode():
            return {
                "threefry_gumbel": timer(lambda: prng.gumbel(
                    key, (rows, V), device="cuda"), iters=5),
                "sort": timer(lambda: torch.sort(lg, dim=-1,
                                                 descending=True), iters=5),
                "sample_plain": timer(lambda: ServingEngine._sample(
                    Plain, lg, temp, key, True), iters=5),
                "sample_rich": timer(lambda: ServingEngine._sample_rich(
                    None, lg, temp, key, tk, tp, rp, seen, allowed, True),
                    iters=5),
                "greedy_argmax": timer(lambda: lg.argmax(dim=-1), iters=5)}

    def scratch_program(eng, fam, key):
        """Operands of ``key`` with every row on the scratch page (as
        warmup_programs gives them), temperature 0.8 and, for a rich
        key, the rich mix's filters."""
        mb, mp = eng.max_b, eng.dec.max_pages
        sb, ss = eng._scratch_block, eng._scratch_slot
        if fam == "ragged":
            T, W, _, rich = key
            z = np.zeros((T, W), np.int32)
            sched = np.stack([z, z, np.full((T, W), ss, np.int32),
                              np.full((T, W), mb, np.int32), z, z])
            arrays = [np.zeros(W, np.int32), sched,
                      np.full((mb + 1, mp), sb, np.int32),
                      np.full((T, W), 0.8, np.float32),
                      prng.split(prng.PRNGKey(6), T).view(np.int32)]
            shape = (T, W)
        else:
            b, w, _, rich = key
            z = np.zeros(w, np.int32)
            arrays = [np.zeros((w, b), np.int32),
                      np.full((w, b), ss, np.int32), z,
                      np.full(w, 0.8, np.float32),
                      prng.PRNGKey(6).view(np.int32)]
            shape = (w,)
        if rich:
            arrays += [np.full(shape, 40, np.int32),
                       np.full(shape, 0.9, np.float32),
                       np.full(shape, 1.3, np.float32)]
            if fam == "ragged":
                arrays.append(np.ones(shape[1], np.int32))
        return arrays

    def serve_rich_int4():
        """The rich mix on both 8B engines after warmup_programs +
        seal_programs (serve-graphs' engines): no unexpected recompile,
        the launches equal what the dispatches call for, the streams
        equal a fresh eager engine's, the twins equal, the masked
        stream inside its mask; tok/s of the rich mix against the plain
        mix (serve-dense-int4's requests) alternated, 3 runs each; a
        decode chunk (T 8, 8 sequences, ctx 512) greedy, sampled and
        rich, device ms a step with the sort kernels' share, and the
        widest chunk the run dispatched, plain against rich; the
        sampler's parts timed alone at 8 rows and that width."""
        dec = the_dec()
        plain = dense_requests()
        specs, mask = rich_specs([p for p, _ in plain], cfg.vocab_size, 32)
        L = cfg.num_hidden_layers
        info = {}
        for name, ragged in (("ragged", True), ("dense", False)):
            eng = sealed_engine(name)
            reset_dense()
            eng.programs.dispatches.clear()
            g_outs, _, g_st = drive(eng, specs)
            launched = dense_counts()
            disp = dict(eng.programs.dispatches)
            expect = graph_launches(disp, L)
            _require(launched == expect,
                     f"{name} rich mix launched {launched}, the dispatches "
                     f"{disp} call for {expect}")
            _require(all(launched[k] > 0 for k in path_kernels(ragged)),
                     f"{name} rich mix: a kernel of the path never "
                     f"launched: {launched}")
            _require(g_st["unexpected_recompiles"] == 0,
                     f"{name} rich mix: {g_st['unexpected_recompiles']} "
                     f"unexpected recompiles after seal_programs")
            rich_disp = {f"{f}{list(k)}": n for (f, k), n in disp.items()
                         if f in ("ragged", "decode", "prefill",
                                  "prefill_prefix") and k[-1]}
            _require(rich_disp, f"{name}: no rich program dispatched")
            twin_gaps = check_rich(
                g_outs, mask, f"8B rich mix ({name})",
                gap=lambda i, a, b: first_gap(dec, specs[i][0], a, b))
            # a fresh eager engine draws from PRNGKey(0): so does the
            # sealed engine's next run
            eng._key = prng.PRNGKey(0)
            g_outs, _, _ = drive(eng, specs)
            e_outs, _, _ = serve(dec, 8, ragged=ragged, reqs=specs)
            for i, (a, b) in enumerate(zip(g_outs, e_outs)):
                _require(np.array_equal(a, b),
                         f"{name} rich request {i} ({specs[i][1]}) differs "
                         f"between graphs and eager programs")
            runs = {"plain": [], "rich": []}
            for _ in range(3):
                for mix, reqs in (("plain", plain), ("rich", specs)):
                    _, wall, st = drive(eng, reqs)
                    runs[mix].append(st["generated_tokens"] / wall)
            # a decode chunk at ctx 512: greedy, sampled, rich
            fam, base, sids = chunk_case(dec, ragged, eng._scratch_block)
            chunk = {}
            with torch.inference_mode():
                for tag, sampled, rich in (("greedy", False, False),
                                           ("sampled", True, False),
                                           ("rich", True, True)):
                    key, arrays = flavour(fam, base, sampled, rich)
                    eng.programs.run(fam, key, arrays)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(5):
                        eng.programs.run(fam, key, arrays)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                    prof = _device_breakdown(
                        torch, lambda: [eng.programs.run(fam, key, arrays)
                                        for _ in range(5)], wall)
                    fams = prof["device_ms_by_family"]
                    chunk[tag] = {
                        "step_device_ms": prof["device_ms"] / 40,
                        "step_wall_ms": wall / 40,
                        "sort_share": fams.get("sort", 0.0)
                        / prof["device_ms"],
                        "top_other": prof["top_other"]}
            for sid in sids:
                dec.cache.free(sid)
            # the widest program the rich run dispatched, plain and rich
            wide_fam = "ragged" if ragged else "prefill"
            wide = max([k for (f, k) in disp if f == wide_fam]
                       or [(512, 4) if not ragged else (1, 8)],
                       key=lambda k: k[0] * k[1])
            widest = {}
            with torch.inference_mode():
                for rich in (False, True):
                    key = tuple(wide[:2]) + (True, rich)
                    arrays = scratch_program(eng, wide_fam, key)
                    widest["rich" if rich else "plain"] = timer(
                        lambda: eng.programs.run(wide_fam, key, arrays),
                        iters=5)
            rows = wide[1]
            info[name] = {
                "launches": launched, "rich_dispatches": rich_disp,
                "unexpected_recompiles": g_st["unexpected_recompiles"],
                "graphs_equal_eager": True,
                "twin_divergences": twin_gaps,
                "masked_inside_mask": True,
                "tok_per_s": {mix: {"runs": v, "median": float(np.median(v))}
                              for mix, v in runs.items()},
                "chunk_T8_W8_ctx512": chunk,
                "widest": {"family": wide_fam, "key": list(wide),
                           "device_ms": widest},
                "sampler_ms_8_rows": sampler_costs(8),
                f"sampler_ms_{rows}_rows": sampler_costs(rows)}
        info["capture"] = shared.get("capture")
        return info

    _phase("serve-rich-int4", serve_rich_int4)

    FAULT_BLOCKS = 21          # blocks of 64 the fault phase's engines get

    def serve_faults_int4():
        """Optimistic admission on a tight pool (8 requests of 300..512
        prompt tokens, 64 new, on 21 free blocks of 64 -- the rest of the
        decoder's pool held by a placeholder sequence), both engines, as
        CUDA graphs after warmup_programs + seal_programs: a clean run
        that preempts at least 4 times with the high-priority request
        never preempted; then the same requests with a cancel mid-decode,
        a deadline abort and a seeded ChaosMonkey (dispatch and
        collection faults at 0.05, allocator OOMs at 0.01, no backoff),
        the pool checked after every step. Gates: every retry and every
        exhaustion answers one injected fault, every failed request
        names one; no unexpected recompile; each finished stream equals
        the worst-case run's, or leaves it at a near-tie (serve-prefix-int4's
        rule: a logit gap of at most twice the noise);
        tok/s optimistic against worst-case on the same requests,
        alternated once (twice until the smoke's time had to make room
        for the tp training phases)."""
        dec = the_dec()
        cache = dec.cache
        cache.clear_prefix_cache()
        hold = cache.free_blocks - FAULT_BLOCKS
        cache.allocate(-2, hold * cache.block_size)
        frng = np.random.RandomState(9)
        f_prompts = [frng.randint(0, cfg.vocab_size, int(n))
                     for n in frng.randint(300, 513, 8)]
        base = [(p, dict(max_new_tokens=64, priority=int(i == 0)))
                for i, p in enumerate(f_prompts)]
        info = {"free_blocks": FAULT_BLOCKS}
        try:
            for name, ragged in (("ragged", True), ("dense", False)):
                wc = sealed_engine(name)
                opt = engine(dec, ragged, graphs=True,
                             admission="optimistic", retry_backoff_s=0.0)
                t0 = time.perf_counter()
                opt.warmup_programs()
                opt.seal_programs()
                torch.cuda.synchronize()
                cap_s = time.perf_counter() - t0
                runs = {"optimistic": [], "worst_case": []}
                outs = {}
                for _ in range(1):      # one round: the smoke's time budget
                    for mode, eng in (("optimistic", opt),
                                      ("worst_case", wc)):
                        rids = [eng.add_request(p, SamplingParams(**kw))
                                for p, kw in base]
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        while eng.step():
                            cache.debug_check()
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t1
                        st = eng.stats()
                        _clean_run(st, f"{name} {mode}")
                        outs[mode] = [eng.result(r) for r in rids]
                        runs[mode].append({
                            "tok_per_s": st["generated_tokens"] / wall,
                            "preemptions": st["preemptions"],
                            "recompute_tokens": st["recompute_tokens"],
                            "hi_priority_epoch": eng.request(
                                rids[0]).epoch})
                        _require(st["finished"] == 8
                                 and st["unexpected_recompiles"] == 0,
                                 f"{name} {mode}: {st['finished']} finished, "
                                 f"{st['unexpected_recompiles']} unexpected "
                                 f"recompiles")
                        eng.clear_finished()
                        cache.clear_prefix_cache()
                for r in runs["optimistic"]:
                    _require(r["preemptions"] >= 4
                             and r["hi_priority_epoch"] == 0,
                             f"{name}: the tight pool preempted "
                             f"{r['preemptions']} times (4 wanted), the "
                             f"high-priority request's epoch "
                             f"{r['hi_priority_epoch']}")
                clean_gaps = [first_gap(dec, p, a, b) for (p, _), a, b
                              in zip(base, outs["optimistic"],
                                     outs["worst_case"])]
                for g in clean_gaps:
                    _require(g is None or abs(g[1]) <= 2 * g[2],
                             f"{name}: a recomputed stream leaves the "
                             f"worst-case one at (token, gap, noise) {g}")
                # the chaos run
                specs = [(p, dict(kw)) for p, kw in base]
                # request 7 (last in line) expires while it waits; seed 1
                # injects dispatch and collection faults, allocator OOMs
                # and an exhausted retry on this schedule (a CPU run of
                # the scheduler alone with the chip's call sequence)
                specs[7][1]["deadline_s"] = 0.02
                monkey = ChaosMonkey(seed=1, p_dispatch=0.05, p_collect=0.05,
                                     p_alloc_oom=0.01).attach(opt)
                reset_dense()
                rids = [opt.add_request(p, SamplingParams(**kw))
                        for p, kw in specs]
                cancelled = None         # (request, tokens it had)
                while opt.step():
                    cache.debug_check()
                    if cancelled is not None:
                        continue
                    for i in range(1, 7):
                        r = opt._find_request(rids[i])
                        if r.state == "running" and len(r.out_tokens) >= 4:
                            opt.cancel(rids[i])
                            cancelled = (i, len(r.out_tokens))
                            break
                monkey.detach(opt)
                launched = dense_counts()
                st = opt.stats()
                faults = monkey.counts["dispatch_faults"] \
                    + monkey.counts["collect_faults"]
                _require(st["retries"] + st["dispatch_exhaustions"] == faults,
                         f"{name}: {st['retries']} retries and "
                         f"{st['dispatch_exhaustions']} exhaustions for "
                         f"{faults} injected faults ({monkey.log})")
                _require(all(launched[k] > 0 for k in path_kernels(ragged)),
                         f"{name} chaos run launched {launched}")
                _require(st["unexpected_recompiles"] == 0,
                         f"{name} chaos run: {st['unexpected_recompiles']} "
                         f"unexpected recompiles")
                states, gaps = {}, []
                for i, rid in enumerate(rids):
                    req = opt.request(rid)
                    states[i] = req.state
                    if req.state == "failed":
                        _require("chaos: injected" in (req.error or ""),
                                 f"{name}: request {i} failed without an "
                                 f"injected fault: {req.error}")
                    elif req.state == "aborted":
                        _require(cancelled is not None
                                 and i in (cancelled[0], 7),
                                 f"{name}: request {i} aborted: {req.error}")
                    else:
                        g = first_gap(dec, f_prompts[i], req.out_tokens,
                                      outs["worst_case"][i])
                        _require(g is None or abs(g[1]) <= 2 * g[2],
                                 f"{name}: request {i} under chaos leaves "
                                 f"the clean stream at {g}")
                        gaps.append(g)
                _require(cancelled is not None
                         and opt.request(rids[cancelled[0]]).error
                         == "cancelled"
                         and "deadline" in (opt.request(rids[7]).error or ""),
                         f"{name}: cancel {cancelled} / deadline did not "
                         f"abort: {states}")
                opt.close()
                cache.debug_check()

                def med(mode, k):
                    return float(np.median([r[k] for r in runs[mode]]))

                info[name] = {
                    "capture_s": cap_s, "runs": runs,
                    "tok_per_s_optimistic": med("optimistic", "tok_per_s"),
                    "tok_per_s_worst_case": med("worst_case", "tok_per_s"),
                    "clean_first_divergences": clean_gaps,
                    "chaos": {"counts": dict(monkey.counts),
                              "log": monkey.log[:40],
                              "stats": {k: st[k] for k in (
                                  "preemptions", "recompute_tokens",
                                  "retries", "aborted", "failed",
                                  "deadline_misses",
                                  "dispatch_exhaustions", "finished")},
                              "states": states, "cancelled_at": cancelled,
                              "first_divergences": gaps,
                              "launches": launched}}
        finally:
            cache.free(-2)
        return info

    _phase("serve-faults-int4", serve_faults_int4)

    # -- multi-step windows, speculative decoding, many-LoRA ------------------
    def family_run(dec, specs, **kw):
        """specs [(prompt, SamplingParams kwargs)] through a fresh tiny
        ragged engine on dec: (streams, stats)."""
        eng = ServingEngine(dec, ragged=True, max_batch_size=3, chunk_size=4,
                            prefill_chunk=8, prompt_buckets=(16, 32), **kw)
        rids = [eng.add_request(p, SamplingParams(**sp)) for p, sp in specs]
        eng.run_to_completion()
        st = eng.stats()
        _clean_run(st, f"tiny family run {sorted(kw)}: "
                       f"{[eng.request(r).error for r in rids]}")
        _require(st["finished"] == len(specs),
                 f"tiny family run {sorted(kw)}: {st['finished']} finished")
        outs = [eng.result(r).tolist() for r in rids]
        eng.close()
        dec.cache.debug_check()
        return outs, st

    def tiny_registry():
        reg = AdapterRegistry(rank=2)
        for i in range(2):
            reg.register_random(f"a{i}", seed=100 + i, scale=0.2)
        return reg

    def plain_lora_delta(lay, flat, row_seq, x, li, name):
        """The JAX package's formulation of one module's delta: each
        row's A and B gathered by its slot, float32 einsums."""
        off_a, off_b, din, dout, _ = lay.entry(li, name)
        s, r = flat.shape[0], lay.rank
        a = flat[:, off_a:off_a + din * r].reshape(s, din, r)[row_seq.long()]
        b = flat[:, off_b:off_b + r * dout].reshape(s, r, dout)[
            row_seq.long()]
        xa = torch.einsum("wd,wdr->wr", x.float(), a)
        return torch.einsum("wr,wro->wo", xa, b).to(x.dtype)

    def tiny_ms_spec_lora_parity():
        """llama_tiny float32 with int4 weights, the card (graphs) against
        the CPU (plain versions): multi_step=4, SpecConfig(draft_len=4)
        with the n-gram drafter on motif prompts, and a mixed batch over
        two register_random adapters and a base row each give equal
        greedy streams on both; on the card each equals its multi_step=1,
        spec-off or registry-less engine (base rows, for LoRA); one
        _lora_delta on the card within 1e-4 of the plain gathered
        formulation."""
        cfg_t = llama_tiny()
        cpu, gpu = cpu_and_card(cfg_t)
        V = cfg_t.vocab_size
        trng = np.random.RandomState(11)
        ps = [trng.randint(0, V, n) for n in (12, 9, 17)]
        motifs = [np.tile(trng.randint(0, V, 5), 3) for _ in range(2)]
        cases = {
            "multi_step": ([(p, dict(max_new_tokens=14)) for p in ps],
                           lambda: dict(multi_step=4), dict(multi_step=1)),
            "spec": ([(p, dict(max_new_tokens=16)) for p in motifs + ps[:1]],
                     lambda: dict(spec_decode=SpecConfig(draft_len=4)),
                     dict()),
            "lora": ([(p, dict(max_new_tokens=10, adapter_id=a))
                      for p, a in zip(ps, ("a0", None, "a1"))],
                     lambda: dict(lora=tiny_registry()), None)}
        info = {}
        reset_dense()
        for name, (specs, kw, base_kw) in cases.items():
            res = {d: family_run(dec, specs, **kw())
                   for d, dec in (("cpu", cpu), ("card", gpu))}
            _require(res["card"][0] == res["cpu"][0],
                     f"tiny {name}: card and CPU streams differ: {res}")
            if base_kw is None:     # base rows against no registry
                plain = [(p, {k: v for k, v in sp.items()
                              if k != "adapter_id"}) for p, sp in specs]
                base, _ = family_run(gpu, plain)
                rows = [i for i, (_, sp) in enumerate(specs)
                        if sp["adapter_id"] is None]
                _require(all(res["card"][0][i] == base[i] for i in rows),
                         f"tiny lora: base rows leave the registry-less "
                         f"engine's streams")
                _require(any(res["card"][0][i] != base[i] for i in
                             range(len(specs)) if i not in rows),
                         "tiny lora: no adapter changed its stream")
            else:
                base, _ = family_run(gpu, specs, **base_kw)
                _require(res["card"][0] == base,
                         f"tiny {name}: streams leave the baseline engine's")
            st = res["card"][1]
            info[name] = {k: st[k] for k in (
                "multi_step_windows", "drafted_tokens",
                "accepted_draft_tokens", "adapter_cache_misses",
                "lora_rows_per_dispatch")}
        _require(info["multi_step"]["multi_step_windows"] >= 1
                 and info["spec"]["accepted_draft_tokens"] > 0
                 and info["lora"]["adapter_cache_misses"] == 2,
                 f"tiny families did not run their programs: {info}")
        launched = dense_counts()
        _require(launched["ragged_paged_attention"] > 0
                 and launched["decode_matmul"] > 0,
                 f"tiny-ms-spec-lora-parity launched {launched}")
        # one delta on the card: every module of layer 1, 9 slots (the
        # last the null adapter), 8 rows
        lay = LoRALayout(gpu.lora_target_modules(),
                         cfg_t.num_hidden_layers, 8, 4096)
        flat = torch.randn(9, lay.capacity, device="cuda",
                           generator=gen) * 0.1
        flat[8] = 0.0
        row_seq = torch.tensor([0, 3, 8, 3, 5, 8, 1, 0], dtype=torch.int32,
                               device="cuda")
        factors = gpu.lora_factors(lay, flat)
        derr = 0.0
        for mod, din, _, _ in lay.modules:
            x = torch.randn(8, din, device="cuda", generator=gen)
            got = gpu._lora_delta(factors, row_seq, x, 1, mod)
            want = plain_lora_delta(lay, flat, row_seq, x, 1, mod)
            derr = max(derr, float((got - want).abs().max()))
        _require(derr <= 1e-4, f"_lora_delta on the card off the plain "
                               f"formulation by {derr}")
        info.update(launches=launched, lora_delta_max_abs_err=derr,
                    tokens_equal=True)
        return info

    _phase("tiny-ms-spec-lora-parity", tiny_ms_spec_lora_parity)

    def lazy_capture(eng, mem0, grid="keys the runs above used"):
        """Seal an engine (again, if warmup_programs sealed it already):
        graphs, their capture seconds (the compile records) and the
        reserved memory grown since ``mem0``. A whole warmup_programs
        grid costs 30-130 s an engine at 8B, measured per configuration
        by tools/serving_grid_probe.py; serve-spec-int4's draft_len 3
        engine takes its whole grid before any traffic, the other new
        engines capture what their traffic uses, and the alternated runs
        after the seal compile nothing."""
        eng.seal_programs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return {"graphs": eng.programs.captured,
                "seconds": sum(r["wall_s"] for r in
                               eng.compile_watch.records),
                "pool_gb": (torch.cuda.memory_reserved() - mem0) / 1e9,
                "grid": grid}

    def drive_checked(eng, reqs, where):
        """drive() with the phase gates: launches equal what the program
        dispatches call for (each shard's kernels under tp), every kernel
        of the engine's path launched, no unexpected recompile. Returns
        (tokens, wall s, stats, launches)."""
        reset_dense()
        eng.programs.dispatches.clear()
        outs, wall, st = drive(eng, reqs)
        launched = dense_counts()
        expect = {k: v * eng.dec.n_shards for k, v in graph_launches(
            eng.programs.dispatches, eng.dec.cfg.num_hidden_layers).items()}
        _require(launched == expect,
                 f"{where}: launched {launched}, the dispatches "
                 f"{dict(eng.programs.dispatches)} call for {expect}")
        _require(all(launched[k] > 0 for k in path_kernels(eng.ragged)),
                 f"{where}: a kernel of the path never launched: {launched}")
        _require(st["unexpected_recompiles"] == 0,
                 f"{where}: {st['unexpected_recompiles']} unexpected "
                 f"recompiles after seal_programs")
        return outs, wall, st, launched

    def greedy_gaps(dec, reqs, outs_a, outs_b, where):
        """Greedy streams of two engines: equal, or parted at a near-tie
        (serve-prefix-int4's rule). Returns the divergences."""
        gaps = []
        for (p, t), a, b in zip(reqs, outs_a, outs_b):
            t = t.get("temperature", 0.0) if isinstance(t, dict) else t
            if t > 0:
                continue
            g = first_gap(dec, p, a, b)
            _require(g is None or abs(g[1]) <= 2 * g[2],
                     f"{where}: greedy streams part at (token, logit gap, "
                     f"noise) {g}, beyond a near-tie")
            if g is not None:
                gaps.append(g)
        return gaps

    def alternate(engines, reqs_of, reps=3):
        """Sealed engines {name: engine} driven in turns, ``reps`` runs
        each, none compiling: tok/s, TTFT p50 / p99, ITL p50 / p99 and
        the delivery gaps' p50 / max as median, min, max. The engine's ITL
        splits the wall between two deliveries to a request evenly over
        the tokens the second one brings; a delivery gap is that wall
        whole (a window's or a verify's tokens arrive together)."""
        runs = {n: [] for n in engines}
        for _ in range(reps):
            for n, eng in engines.items():
                gaps, note = [], eng._note_itl

                def noted(req, now, delivered, note=note, gaps=gaps):
                    if delivered and req.t_last_emit is not None:
                        gaps.append(now - req.t_last_emit)
                    note(req, now, delivered)
                eng._note_itl = noted
                try:
                    _, wall, st = drive(eng, reqs_of[n])
                finally:
                    del eng._note_itl
                _require(st["unexpected_recompiles"] == 0,
                         f"{n}: {st['unexpected_recompiles']} unexpected "
                         f"recompiles after seal_programs")
                runs[n].append({"tok_per_s": st["generated_tokens"] / wall,
                                "ttft_p50_s": st["ttft_p50_s"],
                                "ttft_p99_s": st["ttft_p99_s"],
                                "itl_p50_s": st["itl_p50_s"],
                                "itl_p99_s": st["itl_p99_s"],
                                "gap_p50_s": float(np.median(gaps)),
                                "gap_max_s": max(gaps)})
        return {n: {k: {"runs": [r[k] for r in rs],
                        "median": float(np.median([r[k] for r in rs])),
                        "min": min(r[k] for r in rs),
                        "max": max(r[k] for r in rs)} for k in rs[0]}
                for n, rs in runs.items()}

    def serve_ms_int4():
        """multi_step=4 on the 8B int4 ragged engine as graphs (32-ministep
        windows at the rung of 8; captured as the first run uses them,
        then sealed), against serve-graphs' sealed multi_step=1 engine
        on serve-dense-int4's 8 requests: launches, greedy streams equal
        or a near-tie, windows dispatched, capture; then the two
        alternated, 3 runs each, compiling nothing."""
        dec = the_dec()
        reqs = dense_requests()
        base = sealed_engine("ragged")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        ms = engine(dec, True, graphs=True, multi_step=4)
        b_outs, _, _ = drive(base, reqs)
        m_outs, _, m_st, launched = drive_checked(ms, reqs, "serve-ms-int4")
        capture = lazy_capture(ms, mem0)
        _require(m_st["multi_step_windows"] >= 1,
                 "serve-ms-int4: no window dispatched")
        gaps = greedy_gaps(dec, reqs, m_outs, b_outs, "serve-ms-int4")
        alt = alternate({"k1": base, "k4": ms}, {"k1": reqs, "k4": reqs})
        # where a run's wall goes: device ms and the idle share of one
        # run of each (the alternated median wall)
        runs_prof = {}
        for name, eng in (("k1", base), ("k4", ms)):
            wall = 256 / alt[name]["tok_per_s"]["median"]
            prof = _device_breakdown(torch, lambda: drive(eng, reqs),
                                     wall * 1e3)
            runs_prof[name] = {"device_ms": prof["device_ms"],
                               "wall_ms": wall * 1e3,
                               "idle_share": prof["idle_share"]}
        # one 32-ministep window at W 8, ctx 512, as a graph, against
        # a T 8 chunk of the k = 1 engine: device ms a ministep (sampled
        # keys, as the run's own: the sealed ms engine holds those)
        fam, arrays, sids = chunk_case(dec, True, ms._scratch_block, T=32)
        win = {}
        with torch.inference_mode():
            for name, eng, f, key, ops in (
                    ("k4_window", ms, "ragged_ms", (32, 8, True, False),
                     arrays + [np.full(8, -1, np.int32)]),
                    ("k1_chunk", base, "ragged", (8, 8, True, False),
                     [arrays[0], arrays[1][:, :8], arrays[2],
                      arrays[3][:8], arrays[4][:8]])):
                win[name] = timer(lambda: eng.programs.run(f, key, ops),
                                  iters=5) / key[0]
        for sid in sids:
            dec.cache.free(sid)
        _require(ms.programs.unexpected == 0,
                 "serve-ms-int4: the window timing compiled a key")
        ms.close()
        return {"capture": capture, "capture_k1": shared.get(
                    "capture", {}).get("ragged"),
                "launches": launched,
                "windows_per_run": m_st["multi_step_windows"],
                "device_dispatches": m_st["device_dispatches"],
                "tokens_per_dispatch": m_st["tokens_per_dispatch"],
                "unexpected_recompiles": m_st["unexpected_recompiles"],
                "greedy_divergences": gaps, "alternated": alt,
                "run_profile": runs_prof,
                "ministep_device_ms_W8_ctx512": win}

    _phase("serve-ms-int4", serve_ms_int4)

    def motif_requests(eng, n=8, new=64):
        """Prompts that quote and continue their own text (code editing,
        summaries quoting the source): a passage, then its opening again,
        greedy. The passage is a seed of 40..80 random tokens and the
        model's own greedy continuation of it (64 tokens, served on
        ``eng`` first), so the text a request goes on with may stand
        earlier in its prompt, as quoted text does for a trained model
        (random weights continue nothing of their own accord)."""
        mrng = np.random.RandomState(14)
        seeds = [mrng.randint(0, cfg.vocab_size, int(mrng.randint(40, 81)))
                 for _ in range(n)]
        conts, _, _ = drive(eng, [(s, dict(max_new_tokens=64))
                                  for s in seeds])
        return [(np.concatenate([s, c, s]), dict(max_new_tokens=new))
                for s, c in zip(seeds, conts)]

    class SwitchDrafter(Drafter):
        """The n-gram drafter, or with ``refs`` set an oracle proposing
        the spec-off stream of the same request (the acceptance a draft
        model that agreed with the target would reach)."""

        def __init__(self):
            self.ngram = SpecConfig().make_drafter()
            self.refs = None

        def propose(self, history, k):
            if self.refs is None:
                return self.ngram.propose(history, k)
            h = np.asarray(history, np.int32)
            for p, out in self.refs:
                if h.size >= p.size and np.array_equal(h[:p.size], p):
                    done = h.size - p.size
                    return np.asarray(out[done:done + k], np.int32)
            return np.zeros(0, np.int32)

    def spec_run(eng, reqs, where):
        """drive_checked on a spec engine, counting the tokens its verify
        dispatches delivered (first tokens of finals riding them
        included). Returns (tokens, stats, launches, spec info)."""
        collect, delivered = eng._collect_spec, [0]

        def counted(ch):
            before = eng.generated_tokens
            collect(ch)
            delivered[0] += eng.generated_tokens - before
        eng._collect_spec = counted
        try:
            outs, _, st, launched = drive_checked(eng, reqs, where)
        finally:
            del eng._collect_spec
        disp = {k: n for (f, k), n in eng.programs.dispatches.items()
                if f == "spec"}
        n = sum(disp.values())
        return outs, st, launched, {
            "acceptance_rate": st["draft_acceptance_rate"],
            "drafted_tokens": st["drafted_tokens"],
            "accepted_draft_tokens": st["accepted_draft_tokens"],
            "spec_rollbacks": st["spec_rollbacks"],
            "verify_dispatches": n,
            "tokens_per_verify_dispatch": delivered[0] / n if n else 0.0,
            "tokens_per_dispatch": st["tokens_per_dispatch"],
            "verify_widths": {str(k[0]): c for k, c in disp.items()}}

    def serve_spec_int4():
        """Spec decode on the 8B int4 ragged engine as graphs at
        draft_len 3 (verify rows <= 32 at 8 columns: the GEMV) and 8 (72
        rows: the unpacked int4 and cuBLAS route), against serve-graphs'
        sealed spec-off engine on 8 self-quoting requests: with the
        n-gram drafter (acceptance on this traffic), then an oracle
        drafter that proposes the spec-off streams (every column drafts,
        so the verify ministeps reach their full widths), then oracles of
        the previous pass's own streams. The draft_len 3 engine runs
        warmup_programs + seal_programs before its first request, so
        its whole grid (plain chunks and verify widths) is held to no
        unexpected recompile; draft_len 8 captures as the passes use its
        keys, then seals. Gates: launches, no recompile,
        greedy streams equal or a near-tie. Reports acceptance, tokens
        per verify dispatch, the verify ministep's device ms at the
        widths reached, and the three engines alternated with the last
        oracle, 2 runs each (3 until the smoke's time had to make room
        for the tp training phases)."""
        dec = the_dec()
        base = sealed_engine("ragged")
        reqs = motif_requests(base)
        off_outs, _, off_st = drive(base, reqs)
        refs = [(p, o.tolist()) for (p, _), o in zip(reqs, off_outs)]
        info, engines = {}, {"off": base}
        for dl in (3, 8):
            drafter = SwitchDrafter()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved()
            eng = engine(dec, True, graphs=True, spec_decode=SpecConfig(
                draft_len=dl, drafter=drafter))
            if dl == 3:
                eng.warmup_programs()
                eng.seal_programs()
            runs, oracle = {}, refs
            # the n-gram drafter, then the oracle of the spec-off streams,
            # then oracles of the previous pass's own streams until a pass
            # gives back what it was told (random bf16 weights tie at
            # every few tokens, so a verify ministep's other row count
            # leaves the spec-off stream within a few tokens)
            for mode in ("ngram", "oracle_off", "oracle_self",
                         "oracle_self2"):
                drafter.refs = None if mode == "ngram" else oracle
                outs, st, launched, runs[mode] = spec_run(
                    eng, reqs, f"serve-spec d{dl} {mode}")
                runs[mode]["greedy_divergences"] = greedy_gaps(
                    dec, reqs, outs, off_outs, f"serve-spec d{dl} {mode}")
                runs[mode]["launches"] = launched
                if mode == "ngram":
                    continue
                mine = [(p, o.tolist()) for (p, _), o in zip(reqs, outs)]
                if mine == oracle:
                    break
                oracle = mine
            last = list(runs)[-1]
            _require(runs[last]["accepted_draft_tokens"] > 0,
                     f"serve-spec d{dl}: the oracle's drafts were never "
                     f"accepted")
            capture = lazy_capture(
                eng, mem0, "warmup_programs, before any request" if dl == 3
                else "keys the runs above used")
            W = max(int(w) for w in runs["oracle_off"]["verify_widths"])
            arrays = scratch_spec(eng, W)
            with torch.inference_mode():
                verify_ms = timer(lambda: eng.programs.run(
                    "spec", (W, False), arrays), iters=5)
            _require(eng.programs.unexpected == 0,
                     f"serve-spec d{dl}: the verify timing compiled a key")
            info[f"draft_len_{dl}"] = {
                "capture": capture, **runs,
                "verify_ministep_device_ms": {"W": W, "ms": verify_ms}}
            engines[f"d{dl}"] = eng
        info["off_tokens_per_dispatch"] = off_st["tokens_per_dispatch"]
        info["alternated_oracle"] = alternate(engines,
                                              {n: reqs for n in engines},
                                              reps=2)
        with torch.inference_mode():
            key = (1, 8, False, False)
            ops = scratch_program(base, "ragged", key)
            info["plain_ministep_W8_device_ms"] = timer(
                lambda: base.programs.run("ragged", key, ops), iters=5)
        for n in ("d3", "d8"):
            engines[n].close()
        return info

    def scratch_spec(eng, W):
        """A verify ministep's operands of width W on the scratch page,
        greedy."""
        mb, mp = eng.max_b, eng.dec.max_pages
        z = np.zeros(W, np.int32)
        sched = np.stack([z, z, np.full(W, eng._scratch_slot, np.int32),
                          np.full(W, mb, np.int32), z, z,
                          np.arange(W, dtype=np.int32), z])
        return [sched, z, np.full((mb + 1, mp), eng._scratch_block,
                                  np.int32), np.zeros(W, np.float32),
                prng.PRNGKey(6).view(np.int32)]

    _phase("serve-spec-int4", serve_spec_int4)

    def graphed(fn):
        """fn captured as a CUDA graph (after one eager run): its
        replay."""
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        return g.replay

    def serve_lora_int4():
        """Many-LoRA on the 8B int4 ragged engine as graphs: an
        AdapterRegistry(rank=8) of 4 register_random adapters; 8
        requests (serve-dense-int4's prompts, greedy), 2 base and 6 over
        3 adapters. Each run ends by clearing the prefix cache, which
        evicts the parked adapter pages, so the next run faults them
        back in. Graphs are captured as the first run uses them, then
        sealed. Gates: launches, no recompile, base rows equal the
        registry-less engine's (or a near-tie), tenants leave them;
        hits, misses, evictions; the device ms of one dispatch's page
        gather and of one ministep's deltas at W 8; tok/s against
        serve-graphs' sealed engine on the same prompts without
        adapters, alternated, 3 runs each."""
        dec = the_dec()
        plain = [(p, dict(max_new_tokens=32)) for p, _ in dense_requests()]
        aids = [None, "a0", "a1", "a2", None, "a0", "a1", "a2"]
        tenant = [(p, dict(sp, adapter_id=a))
                  for (p, sp), a in zip(plain, aids)]
        reg = AdapterRegistry(rank=8)
        for i in range(4):
            reg.register_random(f"a{i}", seed=200 + i)
        base = sealed_engine("ragged")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        eng = engine(dec, True, graphs=True, lora=reg)
        b_outs, _, _ = drive(base, plain)
        runs = []
        for _ in range(2):
            outs, _, st, launched = drive_checked(eng, tenant,
                                                  "serve-lora-int4")
            runs.append({k: st[k] for k in (
                "adapter_cache_hits", "adapter_cache_misses",
                "adapter_cache_evictions", "lora_rows_per_dispatch")})
        capture = lazy_capture(eng, mem0)
        _require(runs[0]["adapter_cache_misses"] == 3
                 and runs[1]["adapter_cache_evictions"] == 3,
                 f"serve-lora-int4: adapter paging {runs}")
        base_rows = [i for i, a in enumerate(aids) if a is None]
        gaps = greedy_gaps(dec, [plain[i] for i in base_rows],
                           [outs[i] for i in base_rows],
                           [b_outs[i] for i in base_rows],
                           "serve-lora-int4 base rows")
        _require(sum(not np.array_equal(outs[i], b_outs[i])
                     for i in range(8) if aids[i] is not None) >= 3,
                 "serve-lora-int4: the adapters left most streams as the "
                 "base model's")
        lora_disp = {f"{f}{list(k)}": n
                     for (f, k), n in eng.programs.dispatches.items()
                     if "lora" in f}
        _require(lora_disp, "serve-lora-int4: no lora program dispatched")
        # the gather and the deltas alone: 3 adapters resident, 9 slots
        lay = reg.layout
        for a in ("a0", "a1", "a2"):
            reg.acquire(a)
        tables = torch.full((9, lay.n_pages), eng._scratch_block,
                            dtype=torch.int32, device="cuda")
        for s, a in enumerate(("a0", "a1", "a2")):
            tables[s] = torch.as_tensor(reg.resident_blocks(a))
        pool = dec.cache.lora_pool
        row_seq = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32,
                               device="cuda")
        L = cfg.num_hidden_layers
        h, it = cfg.hidden_size, cfg.intermediate_size
        xs = {d: torch.randn(8, d, device="cuda", generator=gen,
                             dtype=torch.bfloat16) for d in (h, it)}
        with torch.inference_mode():
            ctx = dec.lora_context(lay, pool, tables)

            def deltas():
                for li in range(L):
                    for mod, din, _, _ in lay.modules:
                        dec._lora_delta(ctx, row_seq, xs[din], li, mod)
            # as graphs, as the engine runs them: the device's time, not
            # the host's 224 modules of launches
            gather_ms, delta_ms = (timer(graphed(fn), iters=5) for fn in (
                lambda: dec.lora_context(lay, pool, tables), deltas))
            # every module of layer 0 against the plain formulation in
            # float32: the engine's bf16 delta within twice the rounding
            # of a perfect bf16 answer (the control: the float32 answer
            # rounded to bf16), its float32 delta within 1e-4 of the
            # largest |delta|
            flat = pool[tables.reshape(-1).long()].reshape(9, -1)
            derr = dctrl = derr32 = 0.0
            for mod, din, _, _ in lay.modules:
                ref = plain_lora_delta(lay, flat, row_seq, xs[din].float(),
                                       0, mod)
                got = dec._lora_delta(ctx, row_seq, xs[din], 0, mod)
                got32 = dec._lora_delta(ctx, row_seq, xs[din].float(), 0,
                                        mod)
                derr = max(derr, float((got.float() - ref).abs().max()))
                dctrl = max(dctrl, float((ref.to(torch.bfloat16).float()
                                          - ref).abs().max()))
                derr32 = max(derr32, float((got32 - ref).abs().max()
                                           / ref.abs().max()))
        _require(0.0 < dctrl and derr <= 2 * dctrl and derr32 <= 1e-4,
                 f"serve-lora-int4: _lora_delta at 8B widths off the plain "
                 f"formulation: bf16 {derr} (control {dctrl}), float32 "
                 f"{derr32} of the largest |delta|")
        for a in ("a0", "a1", "a2"):
            reg.release(a)
        alt = alternate({"base": base, "lora": eng},
                        {"base": plain, "lora": tenant})
        eng.close()
        return {"capture": capture, "launches": launched,
                "adapter_pages": lay.n_pages,
                "page_elems": lay.page_elems,
                "lora_pool_gb": pool.numel() * 4 / 1e9,
                "paging_per_run": runs, "lora_dispatches": lora_disp,
                "base_row_divergences": gaps,
                "gather_device_ms_per_dispatch": gather_ms,
                "gather_gb": 9 * lay.n_pages * lay.page_elems * 4 / 1e9,
                "deltas_device_ms_per_ministep_W8": delta_ms,
                "delta_bf16_vs_plain_f32_max_abs_err": derr,
                "delta_bf16_rounding_control": dctrl,
                "delta_f32_vs_plain_rel_err": derr32,
                "alternated": alt}

    _phase("serve-lora-int4", serve_lora_int4)

    # -- telemetry and the fleet ---------------------------------------------
    fleet_launches = {}

    def tiny_fleet_parity():
        """The dp-2 in-process Router on llama_tiny, float32, card against
        CPU from one seed: 4 prompts sharing a 16-token prefix, affinity
        on, a ChaosMonkey wedge of replica 0 mid-decode. The fleet tests'
        geometry with head_dim 64 (hidden 256), the least the dense
        kernels take; the dense engine (the Router's default)."""
        cfg_t = llama_tiny(hidden_size=256, intermediate_size=96,
                           vocab_size=256)
        cpu = LlamaForCausalLM(cfg_t, seed=3, device="cpu")
        gpu = LlamaForCausalLM(cfg_t, seed=3, device="cuda")
        gpu.load_numpy_state({n: p.detach().numpy()
                              for n, p in cpu.named_parameters()})
        kw = dict(max_batch_size=3, num_blocks=24, block_size=8,
                  prompt_buckets=(8, 16, 32), chunk_size=4, prefill_chunk=8)
        frng = np.random.RandomState(0)
        pre = frng.randint(0, cfg_t.vocab_size, 16)
        ps = [np.concatenate([pre, frng.randint(0, cfg_t.vocab_size, 8)])
              for _ in range(4)]
        keys = ("routed_requests", "affinity_hits", "spills", "failovers",
                "migrated_requests", "migrated_done", "failed_migrations",
                "shed_requests", "finished", "generated_tokens",
                "retries", "dispatch_exhaustions")
        res = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, "cuda")):
            oracle = ServingEngine(model, device=dev, **kw)
            want = []
            for p in ps:
                rid = oracle.add_request(p, SamplingParams(max_new_tokens=12))
                oracle.run_to_completion()
                want.append(oracle.result(rid).tolist())
            oracle.close()
            reset_dense()
            router = Router(model, dp=2, breaker_threshold=1,
                            max_dispatch_retries=1, retry_backoff_s=0.0,
                            device=dev, **kw)
            fids = [router.add_request(p, SamplingParams(max_new_tokens=12))
                    for p in ps]
            for _ in range(20):
                router.step()
                if any(router._record(f).replica == 0
                       and router.request(f).state == "running"
                       and router.request(f).out_tokens for f in fids):
                    break
            else:
                _require(False, f"tiny-fleet-parity {name}: nothing "
                                f"decoding on replica 0")
            ChaosMonkey(seed=0).attach(router.replicas[0].engine).wedge()
            router.run_to_completion()
            launched = dense_counts()
            st = router.stats()["fleet"]
            res[name] = {"tokens": [router.result(f).tolist() for f in fids],
                         "oracle": want,
                         "replicas": [router._record(f).replica
                                      for f in fids],
                         "fleet": {k: st[k] for k in keys}}
            router.close()
            if name == "card":
                fleet_launches["tiny-fleet-parity"] = launched
                _require(all(launched[k] > 0 for k in path_kernels(False)
                             if k != "decode_matmul"),
                         f"tiny-fleet-parity: a dense kernel never launched "
                         f"on the card: {launched}")
        for name, r in res.items():
            _require(r["tokens"] == r["oracle"],
                     f"tiny-fleet-parity {name}: fleet streams differ from "
                     f"the single engine's: {r}")
        _require(res["card"] == res["cpu"],
                 f"tiny-fleet-parity: card and CPU differ: {res}")
        _require(res["card"]["fleet"]["failovers"] == 1
                 and res["card"]["fleet"]["migrated_requests"] >= 1,
                 f"tiny-fleet-parity: no failover: {res['card']['fleet']}")
        return {"fleet": res["card"]["fleet"],
                "replicas": res["card"]["replicas"],
                "launches": fleet_launches["tiny-fleet-parity"],
                "tokens_equal_card_cpu_oracle": True}

    _phase("tiny-fleet-parity", tiny_fleet_parity)

    def serve_telemetry_int4():
        """serve-graphs' sealed 8B int4 ragged engine on serve-dense-int4's
        requests three ways, alternated, 3 runs each: no telemetry; a
        Tracer with an SLO monitor; profile_every=8 (the engine's own
        registry). The modes set what the constructor's tracer=, slo=
        and profile_every= set: set_telemetry, the monitor and the
        sampling countdown."""
        eng = sealed_engine("ragged")
        reqs = dense_requests()
        pol = SLOPolicy("all", ttft_p99_s=2.0, itl_p99_s=0.05)
        tracer = Tracer()
        samples = []
        rec = eng._prof_record

        def noted(kind, family, host_s, queue_s, execute_s):
            samples.append((family, host_s, queue_s, execute_s))
            rec(kind, family, host_s, queue_s, execute_s)

        def mode(name):
            eng.set_telemetry(tracer if name == "tracer" else None)
            eng._slo = SLOMonitor([pol]) if name == "tracer" else None
            eng._prof_n = 8 if name == "profile" else 0
            eng._prof_countdown = 1 + int(
                np.random.RandomState(0).randint(8))
            eng._prof_metrics = None
            if name == "profile":
                eng._prof_record = noted
            elif "_prof_record" in vars(eng):
                del eng._prof_record

        runs = {"none": [], "tracer": [], "profile": []}
        outs = {}
        slo = None
        reset_dense()
        try:
            for _ in range(3):
                for name in runs:
                    mode(name)
                    o, wall, st = drive(eng, reqs)
                    if name == "tracer":
                        slo = st["slo"]
                    _require(st["unexpected_recompiles"] == 0,
                             f"serve-telemetry-int4 {name}: "
                             f"{st['unexpected_recompiles']} recompiles")
                    outs.setdefault(name, [x.tolist() for x in o])
                    runs[name].append(st["generated_tokens"] / wall)
        finally:
            mode("none")
        launched = dense_counts()
        fleet_launches["serve-telemetry-int4"] = launched
        for name in ("tracer", "profile"):
            for i, (p, t) in enumerate(reqs):
                if t == 0.0:
                    _require(outs[name][i] == outs["none"][i],
                             f"serve-telemetry-int4: {name} changed greedy "
                             f"stream {i}")
        os.makedirs("chiprun_out", exist_ok=True)
        path = "chiprun_out/serve_telemetry_int4.trace.json"
        t0 = time.perf_counter()
        tracer.export(path)
        export_s = time.perf_counter() - t0
        from tools.trace_report import analyze
        with open(path) as f:
            rep = analyze(json.load(f))
        _require(rep["requests"]["begun"] == 3 * len(reqs)
                 and rep["requests"]["states"] == {"done": 3 * len(reqs)},
                 f"serve-telemetry-int4: trace_report read {rep['requests']}")
        med = {n: float(np.median(v)) for n, v in runs.items()}
        by_fam = {}
        for fam, h, q, e in samples:
            by_fam.setdefault(fam, []).append((h, q, e))
        _require(samples, "serve-telemetry-int4: nothing was sampled")
        return {
            "tok_per_s": {n: {"runs": v, "median": med[n]}
                          for n, v in runs.items()},
            "tracer_cost_share": 1.0 - med["tracer"] / med["none"],
            "profile_cost_share": 1.0 - med["profile"] / med["none"],
            "records": tracer.appended, "dropped": tracer.dropped,
            "records_per_run": tracer.appended / 3,
            "export_bytes": os.path.getsize(path), "export_s": export_s,
            "trace_report_phases": sorted(rep["phases"]),
            "profiled_dispatches": len(samples),
            "attribution_p50_s": {
                fam: {"host_schedule": float(np.median([x[0] for x in v])),
                      "dispatch_queue": float(np.median([x[1] for x in v])),
                      "device_execute": float(np.median([x[2] for x in v])),
                      "n": len(v)} for fam, v in by_fam.items()},
            "slo_min_headroom": slo["min_headroom"],
            "slo": {m: {k: slo["policies"]["all"]["metrics"][m][k]
                        for k in ("target_s", "p_s", "headroom")}
                    for m in ("ttft", "itl")},
            "launches_9_runs": launched}

    _phase("serve-telemetry-int4", serve_telemetry_int4)

    def fleet_requests():
        """fleet-int4's 8 requests: 4 opening with serve-prefix-int4's
        384-token prefix, 4 of serve-dense-int4's prompts; 32 new tokens,
        6 greedy and 2 at 0.8 (two of the unshared ones)."""
        shared_p = [p for p, _ in prefix_reqs[:4]]
        own = [p for p, _ in dense_requests()[:4]]
        return [(p, 0.0) for p in shared_p] + list(
            zip(own, [0.0, 0.0, 0.8, 0.8]))

    def fleet_run(router, reqs, wedge_at=None, victim=None):
        """Serve reqs through the Router: the first request, one step (its
        prompt blocks enter replica 0's prefix index), then the rest.
        With ``wedge_at``, replica ``victim`` is wedged once it has a
        request decoding, after that many steps at least; the ms from the
        wedge to each migrated request's next token are noted. Returns
        (tokens, wall s, fleet stats, extras)."""
        fids = [router.add_request(reqs[0][0], SamplingParams(
            max_new_tokens=32, temperature=reqs[0][1]))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.step()
        fids += [router.add_request(p, SamplingParams(max_new_tokens=32,
                                                      temperature=t))
                 for p, t in reqs[1:]]
        extras = {}
        steps = 1
        if wedge_at is not None:
            def decoding():
                return [f for f in fids
                        if router._record(f).replica == victim
                        and router.request(f).state == "running"
                        and router.request(f).out_tokens]
            while steps < wedge_at or not decoding():
                router.step()
                steps += 1
            before = {f: len(router.request(f).out_tokens) for f in fids}
            extras["victims_decoding"] = len(decoding())
            ChaosMonkey(seed=0).attach(router.replicas[victim].engine).wedge()
            tw = time.perf_counter()
            next_ms = {}
            while router.step():
                for f in fids:
                    if router.migrations(f) and f not in next_ms and len(
                            router.request(f).out_tokens) > before[f]:
                        next_ms[f] = (time.perf_counter() - tw) * 1e3
            extras["wedge_to_next_token_ms"] = next_ms
        else:
            router.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = router.stats()
        outs = [router.result(f) for f in fids]
        extras["migrations"] = [router.migrations(f) for f in fids]
        extras["replicas"] = [router._record(f).replica for f in fids]
        extras["recompute_tokens"] = sum(r["recompute_tokens"]
                                         for r in st["replicas"])
        router.clear_finished()
        for rep in router.replicas:
            rep.engine.dec.cache.clear_prefix_cache()
        return outs, wall, st["fleet"], extras

    def check_fleet_streams(dec, reqs, outs, want, migrations, where):
        """Greedy streams against the one engine's: equal, or parted at a
        near-tie (serve-prefix-int4's rule). A replica's batches differ
        from the one engine's (a request prefills with other rows, or
        splices a prefix the other prefilled), and a migrated stream's
        history is prefilled again. Returns (streams equal, greedy
        streams, the divergences as (request, migrated, token, gap,
        noise))."""
        gaps, equal, greedy = [], 0, 0
        for i, ((p, t), a, b) in enumerate(zip(reqs, outs, want)):
            if t > 0:
                continue
            greedy += 1
            g = first_gap(dec, p, a, b)
            _require(g is None or abs(g[1]) <= 2 * g[2],
                     f"{where}: stream {i} (migrated {migrations[i]}) "
                     f"parts at (token, logit gap, noise) {g}, beyond a "
                     f"near-tie")
            if g is None:
                equal += 1
            else:
                gaps.append((i, bool(migrations[i])) + tuple(g))
        return equal, greedy, gaps

    def fleet_int4():
        """Router(dp=2, transport="inproc") of ragged 8B int4 engines on
        one card: both replicas over the_dec's one weight tree, each with
        a pool of its own (160 blocks of 64), graphs captured as the
        traffic uses them. A clean run against serve-graphs' sealed
        engine (one engine, the same requests); a ChaosMonkey wedge of
        replica 1 mid-decode (its requests migrate to replica 0 through
        adopt_request); the wedged replica back through probation; then
        seal and dp 2 against one engine, alternated, 3 runs each."""
        dec = the_dec()
        reqs = fleet_requests()
        one = sealed_engine("ragged")
        want, _, _ = drive(one, reqs)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        decs = []

        def factory(r, devices):
            d = PagedLlamaDecoder(cfg, dec.weights[0], weight_dtype="int4",
                                  block_size=64, num_blocks=160,
                                  device="cuda")
            decs.append(d)
            return engine(d, True, graphs=True)

        router = Router(None, dp=2, engine_factory=factory,
                        breaker_threshold=1, max_dispatch_retries=1,
                        retry_backoff_s=0.0, cooldown_steps=2,
                        probation_steps=1)
        _require(all(d.weights[0]["layers"][0]["wqkv"].q.data_ptr()
                     == dec.weights[0]["layers"][0]["wqkv"].q.data_ptr()
                     and d.cache.k is not dec.cache.k for d in decs),
                 "fleet-int4: replicas do not share the weights, or share "
                 "a pool")
        c_outs, c_wall, c_st, c_ex = fleet_run(router, reqs)
        c_cmp = check_fleet_streams(dec, reqs, c_outs, want, [0] * 8,
                                    "fleet-int4 clean")
        _require(c_st["affinity_hits"] == 3 and c_ex["replicas"][:4]
                 == [0] * 4, f"fleet-int4: affinity routed {c_ex} "
                             f"with {c_st['affinity_hits']} hits")
        reset_dense()
        # keys the migrations' prefills use are captured as they first
        # run (the set is not sealed yet): their seconds are part of the
        # recovery measured below
        n_rec = len(router.replicas[0].engine.compile_watch.records)
        f_outs, f_wall, f_st, f_ex = fleet_run(router, reqs, wedge_at=3,
                                               victim=1)
        recs = router.replicas[0].engine.compile_watch.records[n_rec:]
        launched = dense_counts()
        fleet_launches["fleet-int4"] = launched
        f_cmp = check_fleet_streams(dec, reqs, f_outs, want,
                                    f_ex["migrations"], "fleet-int4 failover")
        _require(f_st["failovers"] == 1 and f_st["failed_migrations"] == 0
                 and f_st["migrated_requests"] == sum(f_ex["migrations"])
                 == f_st["migrated_done"] >= 1 and f_st["finished"] == 8,
                 f"fleet-int4: failover {f_st}")
        _require(len(f_ex["wedge_to_next_token_ms"])
                 == f_st["migrated_requests"],
                 f"fleet-int4: a migrated request never delivered: {f_ex}")
        victim = router.replicas[1]
        victim.engine.chaos.detach(victim.engine)
        victim.engine.chaos = None
        capture = lazy_capture(router.replicas[0].engine, mem0)
        router.seal_programs()
        step_walls = []
        for rep in router.replicas:
            def timed(acks, orig=rep.transport.step):
                res = orig(acks)
                step_walls.append(res.wall)
                return res
            rep.transport.step = timed
        runs = {"dp2": [], "one": []}
        for _ in range(3):
            o, wall, st, ex = fleet_run(router, reqs)
            _require([x.tolist() for x in o][:6]
                     == [x.tolist() for x in c_outs][:6],
                     "fleet-int4: a sealed fleet run's greedy streams differ "
                     "from the capturing run's")
            _require(st["unexpected_recompiles"] == 0,
                     f"fleet-int4: {st['unexpected_recompiles']} recompiles "
                     f"after seal_programs")
            runs["dp2"].append(st["generated_tokens"] / wall)
            _, wall, st = drive(one, reqs)
            runs["one"].append(st["generated_tokens"] / wall)
        _require(victim.state == "healthy",
                 f"fleet-int4: the healed replica is {victim.state}")
        info = {"clean_run": {"replicas": c_ex["replicas"],
                              "affinity_hits": c_st["affinity_hits"],
                              "spills": c_st["spills"],
                              "tok_per_s": c_st["generated_tokens"] / c_wall,
                              "greedy_equal_to_one_engine": c_cmp[:2],
                              "greedy_divergences": c_cmp[2]},
                "failover": {k: f_st[k] for k in (
                    "affinity_hits", "spills", "failovers",
                    "migrated_requests", "migrated_done",
                    "failed_migrations", "finished")},
                "victims_decoding_at_wedge": f_ex["victims_decoding"],
                "wedge_to_next_token_ms": list(
                    f_ex["wedge_to_next_token_ms"].values()),
                "recompute_tokens": f_ex["recompute_tokens"],
                "captures_during_failover": {
                    "graphs": len(recs),
                    "seconds": sum(r["wall_s"] for r in recs)},
                "failover_greedy_equal_to_one_engine": f_cmp[:2],
                "failover_greedy_divergences": f_cmp[2],
                "launches_failover_run": launched,
                "capture_replica0": capture,
                "tok_per_s": {n: {"runs": v, "median": float(np.median(v))}
                              for n, v in runs.items()},
                "healed_replica_state": victim.state}
        shared["fleet_want"] = want
        shared["fleet_clean"] = [x.tolist() for x in c_outs]
        shared["fleet_step_ms"] = 1e3 * float(np.median(step_walls))
        info["sealed_replica_step_ms_p50"] = shared["fleet_step_ms"]
        router.close()
        for d in decs:
            d.cache.clear_prefix_cache()
        decs.clear()
        return info

    _phase("fleet-int4", fleet_int4)

    def fleet_proc_int4():
        """The same model and traffic behind Router(dp=2,
        transport="process"): each spawned worker builds the 8B int4
        decoder from seed 0 (equal seeds, equal weights) and an eager
        ragged engine (_proc_engine_factory). inject_kill() makes replica
        1 SIGKILL itself mid-decode; its requests migrate from the
        Router's journal and the supervisor respawns it onto
        probation."""
        import glob
        dec = the_dec()
        reqs = fleet_requests()
        want = shared.get("fleet_want")
        if want is None:
            want, _, _ = drive(sealed_engine("ragged"), reqs)
        for f in glob.glob("chiprun_out/fleet_proc_worker_*.json"):
            os.remove(f)
        t0 = time.perf_counter()
        router = Router(None, dp=2, transport="process",
                        engine_factory=_proc_engine_factory,
                        breaker_threshold=1, max_dispatch_retries=1,
                        retry_backoff_s=0.0, probation_steps=1,
                        rpc_timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
        rtts, respawns = [], []
        for rep in router.replicas:
            tr = rep.transport

            def timed(acks, orig=tr.step):
                t = time.perf_counter()
                res = orig(acks)
                rtts.append((time.perf_counter() - t, res.wall))
                return res

            def timed_respawn(orig=tr.respawn):
                t = time.perf_counter()
                orig()
                respawns.append(time.perf_counter() - t)

            tr.step = timed
            tr.respawn = timed_respawn
        try:
            c_outs, c_wall, c_st, c_ex = proc_run(router, reqs)
            c_cmp = check_fleet_streams(dec, reqs, c_outs, want, [0] * 8,
                                        "fleet-proc-int4 clean")
            if "fleet_clean" in shared:
                # the in-process fleet's streams, the same replicas'
                # schedules: equal
                _require([x.tolist() for x in c_outs][:6]
                         == shared["fleet_clean"][:6],
                         "fleet-proc-int4: greedy streams differ from "
                         "fleet-int4's")
            k_outs, k_wall, k_st, k_ex = proc_run(router, reqs, kill=1)
            k_cmp = check_fleet_streams(dec, reqs, k_outs, want,
                                        k_ex["migrations"],
                                        "fleet-proc-int4 SIGKILL")
            _require(k_st["worker_exits"] == 1 and k_st["worker_restarts"]
                     == 1 and k_st["failed_migrations"] == 0
                     and k_st["migrated_requests"] >= 1
                     and k_st["finished"] == 8,
                     f"fleet-proc-int4: {k_st}")
            _require(k_ex["state_after_respawn"] == "probation",
                     f"fleet-proc-int4: the respawned replica came back "
                     f"{k_ex['state_after_respawn']}")
        finally:
            router.close()
        notes = []
        for f in sorted(glob.glob("chiprun_out/fleet_proc_worker_*.json")):
            with open(f) as fh:
                notes.append(json.load(fh))
        _require(len(notes) == 3 and not any(n["library_built_here"]
                                             for n in notes),
                 f"fleet-proc-int4: worker library notes {notes}")
        rtt = [a for a, _ in rtts]
        inner = [b for _, b in rtts]
        return {"spawn_s_two_workers": spawn_s, "respawn_s": respawns,
                "workers": notes,
                "clean_tok_per_s": c_st["generated_tokens"] / c_wall,
                "kill_run": {k: k_st[k] for k in (
                    "failovers", "migrated_requests", "migrated_done",
                    "failed_migrations", "worker_exits", "worker_restarts",
                    "heartbeat_misses", "rpc_retries", "finished")},
                "victims_decoding_at_kill": k_ex["victims_decoding"],
                "kill_to_next_token_ms": list(
                    k_ex["wedge_to_next_token_ms"].values()),
                "recompute_tokens": k_ex["recompute_tokens"],
                "clean_greedy_equal_to_one_engine": c_cmp[:2],
                "kill_greedy_equal_to_one_engine": k_cmp[:2],
                "kill_greedy_divergences": k_cmp[2],
                "step_rpc_ms": {"round_trip_p50": 1e3 * float(
                    np.median(rtt)), "worker_step_p50": 1e3 * float(
                    np.median(inner)), "overhead_p50": 1e3 * float(
                    np.median([a - b for a, b in rtts])), "n": len(rtt)},
                "inproc_graph_step_ms_p50": shared.get("fleet_step_ms"),
                "state_after_respawn": k_ex["state_after_respawn"],
                "final_states": k_ex["final_states"]}

    def proc_run(router, reqs, kill=None):
        """fleet_run for the process Router: with ``kill``, that replica
        SIGKILLs itself (inject_kill) once it has a request decoding."""
        fids = [router.add_request(reqs[0][0], SamplingParams(
            max_new_tokens=32, temperature=reqs[0][1]))]
        t0 = time.perf_counter()
        router.step()
        fids += [router.add_request(p, SamplingParams(max_new_tokens=32,
                                                      temperature=t))
                 for p, t in reqs[1:]]
        ex = {}
        if kill is not None:
            def decoding():
                out = []
                for f in fids:
                    if router._record(f).replica != kill:
                        continue
                    v = router.request(f)
                    if v.state == "running" and v.out_tokens:
                        out.append(f)
                return out
            steps = 1
            while steps < 3 or not decoding():
                router.step()
                steps += 1
            before = {f: len(router.request(f).out_tokens) for f in fids}
            ex["victims_decoding"] = len(decoding())
            router.replicas[kill].transport.inject_kill()
            tk = time.perf_counter()
            next_ms = {}
            ex["state_after_respawn"] = None
            while router.has_work:
                router.step()
                if ex["state_after_respawn"] is None and \
                        router.worker_restarts:
                    ex["state_after_respawn"] = router.replicas[kill].state
                for f in fids:
                    if router.migrations(f) and f not in next_ms and len(
                            router.request(f).out_tokens) > before[f]:
                        next_ms[f] = (time.perf_counter() - tk) * 1e3
            ex["wedge_to_next_token_ms"] = next_ms
        else:
            while router.has_work:
                router.step()
        wall = time.perf_counter() - t0
        st = router.stats()
        outs = [router.result(f) for f in fids]
        ex["migrations"] = [router.migrations(f) for f in fids]
        ex["recompute_tokens"] = sum(r.get("recompute_tokens", 0)
                                     for r in st["replicas"])
        ex["final_states"] = [rep.state for rep in router.replicas]
        router.clear_finished()
        return outs, wall, st["fleet"], ex

    _phase("fleet-proc-int4", fleet_proc_int4)

    # -- tensor-parallel serving ----------------------------------------------
    tp_launches = {}

    def tiny_tp_parity():
        """Tensor-parallel serving, card against CPU from one seed: a
        llama_tiny-width float32 model with 4 kv heads and head_dim 64
        (hidden 256, the least the dense kernels take), int4 weights.
        The ragged engine at tp 1, 2 and 4 (every shard on cuda:0, or
        on the CPU; graphs captured as used on the card); the tp-2
        decoder's generate() against tp 1's; Router(dp=2, tp=2) over
        four shard devices, 4 prompts sharing 16 tokens, a ChaosMonkey
        wedge of replica 0 mid-decode, against one tp-1 engine serving
        the prompts one at a time. Greedy streams equal across tp on
        each device, and card == CPU, routing counters too; where the
        card's tp-1 engine parts from the CPU's (a float32 kernel
        against its plain version, the same at every tp), it must part
        at a near-tie: the CPU's logit gap between the two tokens at
        most twice the largest card / CPU logit difference there."""
        cfg_t = llama_tiny(hidden_size=256, num_key_value_heads=4)
        cpu = LlamaForCausalLM(cfg_t, seed=3, device="cpu")
        gpu = LlamaForCausalLM(cfg_t, seed=3, device="cuda")
        gpu.load_numpy_state({n: p.detach().numpy()
                              for n, p in cpu.named_parameters()})
        kw = dict(max_batch_size=3, num_blocks=48, block_size=8,
                  prompt_buckets=(8, 16, 32, 64), chunk_size=4,
                  prefill_chunk=8, weight_dtype="int4")
        trng = np.random.RandomState(5)
        ps = [trng.randint(0, cfg_t.vocab_size, int(n))
              for n in (5, 30, 60, 9)]
        pre = trng.randint(0, cfg_t.vocab_size, 16)
        fps = [np.concatenate([pre, trng.randint(0, cfg_t.vocab_size, 8)])
               for _ in range(4)]
        gen_ids = trng.randint(0, cfg_t.vocab_size, (2, 7)).astype(np.int32)
        keys = ("routed_requests", "affinity_hits", "spills", "failovers",
                "migrated_requests", "migrated_done", "failed_migrations",
                "finished", "generated_tokens", "retries",
                "dispatch_exhaustions")
        res, launched, decs = {}, {}, {}
        for name, model, dev in (("cpu", cpu, "cpu"),
                                 ("card", gpu, "cuda:0")):
            r = res[name] = {}
            for tp in (1, 2, 4):
                place = (dict(device=dev) if tp == 1
                         else dict(devices=[dev] * tp))
                eng = ServingEngine(model, ragged=True, tp=tp, **place, **kw)
                reset_dense()
                rids = [eng.add_request(p, SamplingParams(max_new_tokens=10))
                        for p in ps]
                eng.run_to_completion()
                _clean_run(eng.stats(), f"tiny-tp-parity {name} tp {tp}")
                r[f"tp{tp}"] = [eng.result(i).tolist() for i in rids]
                if name == "card":
                    launched[f"engine_tp{tp}"] = dense_counts()
                eng.close()
            for tp in (1, 2):
                mesh = (None if tp == 1 else ProcessMesh(
                    [0, 1], ["tp"], devices=[dev] * 2))
                dec = PagedLlamaDecoder.from_model(
                    model, num_blocks=32, block_size=8, weight_dtype="int4",
                    device=dev if tp == 1 else None, mesh=mesh,
                    mp_axis="tp", tp_shard_map=tp > 1)
                reset_dense()
                r[f"generate_tp{tp}"] = dec.generate(
                    gen_ids, max_new_tokens=8).tolist()
                if tp == 1:
                    decs[name] = dec
                if name == "card":
                    launched[f"generate_tp{tp}"] = dense_counts()
            oracle = ServingEngine(model, ragged=True, device=dev, **kw)
            want = []
            for p in fps:
                rid = oracle.add_request(p, SamplingParams(max_new_tokens=12))
                oracle.run_to_completion()
                want.append(oracle.result(rid).tolist())
            oracle.close()
            reset_dense()
            router = Router(model, dp=2, tp=2, devices=[dev] * 4,
                            breaker_threshold=1, max_dispatch_retries=1,
                            retry_backoff_s=0.0, **kw)
            fids = [router.add_request(p, SamplingParams(max_new_tokens=12))
                    for p in fps]
            for _ in range(20):
                router.step()
                if any(router._record(f).replica == 0
                       and router.request(f).state == "running"
                       and router.request(f).out_tokens for f in fids):
                    break
            else:
                _require(False, f"tiny-tp-parity {name}: nothing decoding "
                                f"on replica 0")
            ChaosMonkey(seed=0).attach(router.replicas[0].engine).wedge()
            router.run_to_completion()
            st = router.stats()["fleet"]
            r["router"] = [router.result(f).tolist() for f in fids]
            r["router_oracle"] = want
            r["replicas"] = [router._record(f).replica for f in fids]
            r["fleet"] = {k: st[k] for k in keys}
            if name == "card":
                launched["router"] = dense_counts()
                _require([e.engine.dec.devices for e in router.replicas]
                         == [[torch.device("cuda", 0)] * 2] * 2,
                         "tiny-tp-parity: replicas not on their rows")
            router.close()
        for name, r in res.items():
            _require(r["tp2"] == r["tp1"] and r["tp4"] == r["tp1"],
                     f"tiny-tp-parity {name}: tp streams differ: {r}")
            _require(r["generate_tp2"] == r["generate_tp1"],
                     f"tiny-tp-parity {name}: the tp-2 generate() differs")
            _require(r["router"] == r["router_oracle"],
                     f"tiny-tp-parity {name}: the dp x tp Router's streams "
                     f"differ from one engine's: {r}")
        for k in res["cpu"]:
            _require(k in ("tp1", "tp2", "tp4")
                     or res["card"][k] == res["cpu"][k],
                     f"tiny-tp-parity: card and CPU differ in {k}: {res}")
        ties = []
        for p, a, b in zip(ps, res["cpu"]["tp1"], res["card"]["tp1"]):
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if i is None:
                continue
            toks = np.concatenate([p, a[:i]]).astype(np.int32)
            lc = last_logits(decs["cpu"], toks, len(toks))
            lg = last_logits(decs["card"], toks, len(toks)).cpu()
            tie = (i, float(lc[a[i]] - lc[b[i]]),
                   float((lc - lg).abs().max()))
            _require(abs(tie[1]) <= 2 * tie[2],
                     f"tiny-tp-parity: card and CPU part at (token, CPU "
                     f"logit gap, card / CPU logit difference) {tie}, "
                     f"beyond a near-tie")
            ties.append(tie)
        _require(res["card"]["fleet"]["failovers"] == 1
                 and res["card"]["fleet"]["migrated_requests"] >= 1,
                 f"tiny-tp-parity: no failover: {res['card']['fleet']}")
        for k, n in launched.items():
            need = (("paged_attention_decode", "flash_fwd", "decode_matmul")
                    if k.startswith("generate")
                    else ("ragged_paged_attention", "decode_matmul"))
            _require(all(n[x] > 0 for x in need),
                     f"tiny-tp-parity {k}: a kernel never launched: {n}")
        tp_launches["tiny-tp-parity"] = launched
        return {"fleet": res["card"]["fleet"],
                "replicas": res["card"]["replicas"], "launches": launched,
                "card_cpu_near_ties": ties}

    _phase("tiny-tp-parity", tiny_tp_parity)

    def serve_tp2_int4():
        """Llama-3-8B int4 at tp 2 with both shards on one card:
        ServingEngine(dec, tp=2) over a decoder built from seed 0 on
        ProcessMesh(devices=["cuda:0"] * 2) (the same weights as
        serve-int4's, cut by the placement table), bf16 pool of 160
        blocks of 64, serve-int4's 8 requests. fp32 and int8 comm, each
        eager and then as graphs captured as used and sealed: launches
        exactly what the dispatches call for at two shards (64 ragged a
        ministep, twice tp 1's GEMV), graphs == eager on every row, no
        recompile after the seal; fp32 greedy streams equal the sealed
        tp-1 engine's or part at a near-tie; int8 comm on one prefill:
        the argmax equal to fp32's and each of its collectives within the
        reference's per-call bound of its exact sum, the logits'
        relative difference reported, not held (at these weights it
        lies above JAX's llama_tiny 0.02 on the CPU as on the card:
        tools/tp_int8_port_probe.py; its streams are reported, not
        held). Then tok/s, TTFT and ITL of tp 1 / tp 2
        fp32 / tp 2 int8 alternated (3 runs each), a T 8 chunk's device
        ms at W 8 ctx 512 and pool bytes per shard."""
        dec1 = the_dec()
        base = sealed_engine("ragged")
        reqs = list(zip(prompts[:8], temps))
        b_outs, _, _ = drive(base, reqs)
        mesh = ProcessMesh([0, 1], ["tp"], devices=["cuda:0"] * 2)
        info, engines, decs = {}, {}, {}
        for comm in ("fp32", "int8"):
            t0 = time.perf_counter()
            dec = decs[comm] = PagedLlamaDecoder.from_config(
                cfg, seed=0, weight_dtype="int4", block_size=64,
                num_blocks=160, mesh=mesh, mp_axis="tp", tp_shard_map=True,
                tp_comm=comm)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            where = f"serve-tp2-int4 {comm}"
            eager = engine(dec, True, tp=2)
            e_outs, e_wall, e_st, e_launch = drive_checked(
                eager, reqs, where + " eager")
            # the eager run's GEMV launches by shard shape, counted where
            # the kernel launches
            gemv_by_shape = dict(dmm.launches_by_shape)
            _require(sum(gemv_by_shape.values())
                     == e_launch["decode_matmul"],
                     f"{where}: GEMV launches by shape {gemv_by_shape} do "
                     f"not add up to {e_launch['decode_matmul']}")
            eager.close()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved()
            g = engines[comm] = engine(dec, True, graphs=True, tp=2)
            c_outs, _, _, _ = drive_checked(g, reqs, where + " capturing")
            capture = lazy_capture(g, mem0)
            # the sealed run from the engine's first key again, so its
            # sampled rows draw what the eager run's drew
            g._key = prng.PRNGKey(0)
            g_outs, g_wall, g_st, g_launch = drive_checked(
                g, reqs, where + " sealed")
            for i, (a, b, c) in enumerate(zip(g_outs, e_outs, c_outs)):
                _require(np.array_equal(a, b) and np.array_equal(c, b),
                         f"{where}: request {i} differs between graphs and "
                         f"eager")
            if comm == "fp32":
                gaps = greedy_gaps(dec1, reqs, e_outs, b_outs, where)
            else:
                gaps = [first_gap(dec1, p, a, b) for (p, t), a, b
                        in zip(reqs, e_outs, b_outs) if t == 0]
            one, wall_ms, _ = decode_ministep(dec, profile=False)
            _require(one == {"ragged_paged_attention": 64,
                             "decode_matmul": 258},
                     f"{where}: one pure-decode ministep at W=8 launched "
                     f"{one}, expected 64 attention and 258 GEMV kernels")
            info[comm] = {
                "load_s": load_s, "eager_launches": e_launch,
                "sealed_launches": g_launch, "capture": capture,
                "eager_tok_per_s": e_st["generated_tokens"] / e_wall,
                "greedy_divergences_vs_tp1": gaps,
                "streams_equal_tp1": sum(
                    np.array_equal(a, b) for a, b in zip(e_outs, b_outs)),
                "decode_ministep_launches": one,
                "decode_ministep_W8_ctx512_wall_ms": wall_ms,
                "unexpected_recompiles": g_st["unexpected_recompiles"],
                "pool_bytes_per_shard":
                    dec.cache.pool_bytes() / dec.n_shards}
            tp_launches[f"serve-tp2-int4 {comm}"] = dict(
                e_launch, gemv_by_shape=gemv_by_shape)
        # int8 comm against fp32 comm on one prefill (serve-int4's first
        # prompt): the argmax equal, each of its 2 x 32 collectives
        # within the reference's bound of the exact sum of its real
        # inputs (tests/test_tp_serving.py:150: 2.05 quantization steps,
        # plus the bf16 rounding of the result), the logits' relative
        # difference reported beside fp32 comm's against tp 1
        toks = np.asarray(prompts[0], np.int32)
        d8, calls = decs["int8"], []
        reduce8 = d8._block_reduce

        def checked(parts):
            out = reduce8(parts)
            x = torch.stack([p.float() for p in parts])
            exact = x.sum(0)
            step = (float(x.abs().max()) / 127.0 * len(parts)
                    + float(exact.abs().max()) / 127.0)
            calls.append((float((out[0].float() - exact).abs().max()),
                          2.05 * step + float(exact.abs().max()) / 256.0))
            return out

        d8._block_reduce = checked
        try:
            li = last_logits(d8, toks, len(toks))
        finally:
            del d8._block_reduce
        lf = last_logits(decs["fp32"], toks, len(toks))
        l1 = last_logits(dec1, toks, len(toks))
        rel = float((lf - li).abs().max() / lf.abs().max())
        _require(len(calls) == 2 * cfg.num_hidden_layers
                 and all(e <= b for e, b in calls),
                 f"serve-tp2-int4: an int8 all-reduce off the exact sum "
                 f"beyond its bound: {[c for c in calls if c[0] > c[1]]}")
        _require(int(lf.argmax()) == int(li.argmax()),
                 f"serve-tp2-int4: int8-comm prefill argmax "
                 f"{int(li.argmax())} against fp32 comm's "
                 f"{int(lf.argmax())} (rel {rel})")
        info["int8_vs_fp32_logits_rel"] = rel
        info["int8_collective_err_over_bound_max"] = max(e / b
                                                         for e, b in calls)
        info["fp32_vs_tp1_logits_rel"] = float((lf - l1).abs().max()
                                               / l1.abs().max())
        alt = alternate({"tp1": base, "tp2_fp32": engines["fp32"],
                         "tp2_int8": engines["int8"]},
                        {n: reqs for n in ("tp1", "tp2_fp32", "tp2_int8")})
        # a T 8 decode chunk at W 8, ctx 512, as a graph: device ms of
        # the chunk (sampled keys: the run's own, captured above)
        chunk = {}
        key = (8, 8, True, False)
        with torch.inference_mode():
            for name, eng in (("tp1", base), ("tp2_fp32", engines["fp32"]),
                              ("tp2_int8", engines["int8"])):
                _require(("ragged", key) in eng.programs._graphs,
                         f"serve-tp2-int4: {name} holds no graph of {key}")
                fam, arrays, sids = chunk_case(eng.dec, True,
                                               eng._scratch_block)
                before = eng.programs.unexpected
                ms = timer(lambda: eng.programs.run(fam, key, arrays),
                           iters=5)
                prof = _device_breakdown(
                    torch, lambda: eng.programs.run(fam, key, arrays), ms)
                chunk[name] = {"device_ms": ms,
                               "profiled_device_ms": prof["device_ms"],
                               "by_family": prof["device_ms_by_family"],
                               "kernels": prof["device_kernels"],
                               "top_other": prof["top_other"]}
                _require(eng.programs.unexpected == before,
                         f"serve-tp2-int4: the chunk timing compiled {key}")
                for sid in sids:
                    eng.dec.cache.free(sid)
        info["alternated"] = alt
        info["chunk_T8_W8_ctx512_device_ms"] = chunk
        info["pool_bytes_tp1"] = dec1.cache.pool_bytes()
        for eng in engines.values():
            eng.close()
        del engines, decs, dec
        gc.collect()
        torch.cuda.empty_cache()
        # the shard shapes no tp-2 bf16-pool run gives the kernels: an
        # int8 pool at tp 2 and the 8 / 2-head shards of tp 4, eager, on
        # the same requests: launches exactly what the dispatches call
        # for; tp 4's greedy streams against tp 1's near-tie rule
        for leg, n, kvq in (("tp2_kv8", 2, "int8"), ("tp4", 4, None)):
            dec = PagedLlamaDecoder.from_config(
                cfg, seed=0, weight_dtype="int4", block_size=64,
                num_blocks=160, kv_quant=kvq, mp_axis="tp",
                tp_shard_map=True, mesh=ProcessMesh(
                    list(range(n)), ["tp"], devices=["cuda:0"] * n))
            eng = engine(dec, True, tp=n)
            outs, wall, st, launched = drive_checked(
                eng, reqs, f"serve-tp2-int4 {leg}")
            eng.close()
            one, _, _ = decode_ministep(dec, profile=False)
            _require(one == {"ragged_paged_attention": 32 * n,
                             "decode_matmul": 129 * n},
                     f"serve-tp2-int4 {leg}: one W 8 ministep launched {one}")
            info[leg] = {"launches": launched, "ministep_launches": one,
                         "tok_per_s_eager": st["generated_tokens"] / wall,
                         "pool_bytes_per_shard":
                             dec.cache.pool_bytes() / n,
                         "streams_equal_tp1": sum(
                             np.array_equal(a, b)
                             for a, b in zip(outs, b_outs))}
            if kvq is None:
                info[leg]["greedy_divergences_vs_tp1"] = greedy_gaps(
                    dec1, reqs, outs, b_outs, f"serve-tp2-int4 {leg}")
            tp_launches[f"serve-tp2-int4 {leg}"] = launched
            del dec, eng
            gc.collect()
            torch.cuda.empty_cache()
        return info

    _phase("serve-tp2-int4", serve_tp2_int4)


    for eng in shared.get("graph_engines", {}).values():
        eng.close()
    shared.clear()
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

    # -- LlamaForCausalLM whole: card against the CPU -------------------------
    def tiny_model_parity():
        """Tied embeddings and full_attn recompute through TrainStep, the
        model's generate() (greedy, seeded at 0.8) and beam search, and
        ServingEngine(model, weight_dtype="int4") on both schedulers: the
        card and the CPU from one seed."""
        cfg = llama_tiny(hidden_size=256, tie_word_embeddings=True,
                         use_recompute=True,
                         recompute_granularity="full_attn")
        cpu = LlamaForCausalLM(cfg, seed=3, device="cpu")
        # the N(0, 1) table as a tied head makes every stream repeat its
        # last prompt token; scaled, the streams say something
        with torch.no_grad():
            cpu.model.embed_tokens.weight.mul_(0.05)
        gpu = LlamaForCausalLM(cfg, seed=3, device="cuda")
        gpu.load_numpy_state({n: p.detach().numpy()
                              for n, p in cpu.named_parameters()})
        _require(gpu.lm_head is None, "a tied model holds an lm_head")
        ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 100))
        losses = []
        reset_flash()
        for m in (cpu, gpu):
            step = TrainStep(m, m.loss, AdamW(learning_rate=1e-3,
                                              parameters=m.parameters()))
            x = torch.as_tensor(ids, dtype=torch.int32,
                                device=m.model.embed_tokens.weight.device)
            losses.append([float(step(x, x)) for _ in range(2)])
        L = cfg.num_hidden_layers
        train_launched = flash_counts()
        # each step: L forward, L recomputed forward, L dq, L dk/dv
        _require(train_launched == {"flash_fwd": 4 * L, "flash_bwd_dq": 2 * L,
                                    "flash_bwd_dkv": 2 * L},
                 f"2 recompute steps launched {train_launched}")
        rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
        _require(rel < 1e-4, f"tiny-model-parity losses differ: cpu "
                             f"{losses[0]} vs cuda {losses[1]}")
        prompt = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 20))
        gens = {}
        for name, kw in (("greedy", dict(max_new_tokens=12)),
                         ("sampled", dict(max_new_tokens=12, temperature=0.8,
                                          seed=5)),
                         ("beam3", dict(max_new_tokens=8, num_beams=3))):
            out = [m.generate(torch.as_tensor(prompt), **kw).cpu().numpy()
                   for m in (cpu, gpu)]
            _require(np.array_equal(*out),
                     f"generate {name}: cpu {out[0].tolist()} vs cuda "
                     f"{out[1].tolist()}")
            gens[name] = out[1][0, 20:].tolist()
        rng = np.random.RandomState(9)
        prompts_ = [rng.randint(0, cfg.vocab_size, n) for n in (5, 23, 40)]
        streams, launched = {}, {}
        for ragged in (True, False):
            outs = []
            for m, dev in ((cpu, "cpu"), (gpu, None)):
                reset_dense()
                eng = ServingEngine(m, weight_dtype="int4", ragged=ragged,
                                    max_batch_size=3, num_blocks=64,
                                    block_size=16, prompt_buckets=(32, 64),
                                    chunk_size=4, prefill_chunk=16,
                                    device=dev)
                rids = [eng.add_request(p, SamplingParams(max_new_tokens=10))
                        for p in prompts_]
                eng.run_to_completion()
                outs.append([eng.result(r).tolist() for r in rids])
                eng.close()
            name = "ragged" if ragged else "dense"
            launched[name] = dense_counts()
            _require(all(launched[name][k] > 0 for k in path_kernels(ragged)),
                     f"ServingEngine(model) {name} did not launch every "
                     f"kernel of its path: {launched[name]}")
            _require(outs[0] == outs[1], f"ServingEngine(model) {name}: "
                                         f"cpu {outs[0]} vs cuda {outs[1]}")
            streams[name] = outs[1][0]
        return {"model": "llama_tiny(hidden_size=256), tied, full_attn "
                         "recompute, float32",
                "losses_cpu": losses[0], "losses_cuda": losses[1],
                "max_rel_diff": rel, "train_launches": train_launched,
                "generate_row0": gens, "serving_row0": streams,
                "serving_launches": launched}

    _phase("tiny-model-parity", tiny_model_parity)

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
    gc.collect()
    torch.cuda.empty_cache()

    # -- bench.py's 1b row: full_attn recompute, chunked CE, bf16 moments ----
    one_b = {}

    def llama_1b_row(recompute=True):
        """bench.py:204-225's model and optimizer from seed 0: (model,
        optimizer, step)."""
        cfg1 = llama_1b(dtype="bfloat16", use_recompute=recompute,
                        recompute_granularity="full_attn",
                        chunked_ce_tokens=1024)
        model = LlamaForCausalLM(cfg1, seed=0, device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01, moment_dtype="bfloat16")
        return model, opt, TrainStep(model, model.loss, opt)

    def train_1b():
        b, s, warm, iters = 4, 2048, 2, 10
        # what earlier phases left allocated: the peaks are read over it
        start_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        model, opt, step = llama_1b_row()
        cfg1 = model.cfg
        L, H = cfg1.num_hidden_layers, cfg1.num_attention_heads
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg1.vocab_size, size=(b, s)).astype(np.int32), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_dense()
        reset_flash()
        losses = [step(ids, ids) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids, ids) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_steps = warm + iters
        launched = flash_counts()
        one_b["train_launches"] = launched
        per_step = {k_: v / n_steps for k_, v in launched.items()}
        # L forward, L recomputed forward (full_attn), L dq, L dk/dv
        _require(launched == {"flash_fwd": 2 * L * n_steps,
                              "flash_bwd_dq": L * n_steps,
                              "flash_bwd_dkv": L * n_steps},
                 f"{n_steps} recompute steps launched {launched}, expected "
                 f"{2 * L} forward and {L} dq / dk/dv a step")
        _require(all(v == 0 for v in counts().values()),
                 f"training launched serving kernels: {counts()}")
        losses = [float(x) for x in losses]
        _require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        _require(losses[-1] < losses[0],
                 f"the loss did not fall: {losses[0]} -> {losses[-1]}")
        n_params = model.num_params()
        fpt = 6 * n_params + 12 * L * H * (cfg1.hidden_size // H) * s
        step_ms = wall * 1e3 / iters
        prof = _device_breakdown(
            torch, lambda: [step(ids, ids) for _ in range(2)], step_ms * 2)
        for k_ in ("device_ms", "device_kernels", "wall_ms"):
            prof[k_] /= 2
        for k_ in ("device_ms_by_family", "top_other"):
            prof[k_] = {a: v / 2 for a, v in prof[k_].items()}
        # the same row without recompute, from the same seed: its first
        # loss against the recompute model's, then the two alternated
        # (2 steps a run, 3 runs each), each run's peak memory its own
        plain = llama_1b_row(recompute=False)
        reset_flash()
        first_plain = float(plain[2](ids, ids))
        _require(flash_counts() == {"flash_fwd": L, "flash_bwd_dq": L,
                                    "flash_bwd_dkv": L},
                 f"a step without recompute launched {flash_counts()}")
        first_rel = abs(first_plain - losses[0]) / abs(losses[0])
        _require(first_rel < 1e-3, f"first-step losses differ: recompute "
                                   f"{losses[0]}, plain {first_plain}")
        alt = {"recompute": [], "plain": []}
        peak = {"recompute": [], "plain": []}
        for _ in range(3):
            for name, st_ in (("recompute", step), ("plain", plain[2])):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                for _ in range(2):
                    st_(ids, ids)
                torch.cuda.synchronize()
                alt[name].append((time.perf_counter() - t1) * 1e3 / 2)
                peak[name].append(torch.cuda.max_memory_allocated() / 1e9)
        del plain
        del opt, step
        gc.collect()
        torch.cuda.empty_cache()
        model.eval()
        one_b["model"] = model

        def spread(xs):
            xs = sorted(xs)
            return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}

        return {"model": "llama_1b bf16 compute (float32 Linear/Embedding "
                         "weights), 18 layers, full_attn recompute, chunked "
                         "CE 1024, b4 x s2048, AdamW(1e-4, wd 0.01, bf16 "
                         "moments)",
                "num_params": n_params, "init_s": init_s,
                "launches": launched, "launches_per_step": per_step,
                "steps": n_steps, "losses": losses, "step_ms": step_ms,
                "tokens_per_s": b * s / (step_ms / 1e3),
                "mfu": b * s / (step_ms / 1e3) * fpt / BF16_FLOPS_PER_S,
                "flops_per_token": fpt, "peak_mem_gb": peak_gb,
                "allocated_at_start_gb": start_gb,
                "peak_over_start_gb": peak_gb - start_gb,
                "first_step_loss": {"recompute": losses[0],
                                    "plain": first_plain,
                                    "rel_diff": first_rel},
                "alternated_step_ms": {k_: spread(v) for k_, v in alt.items()},
                "alternated_mfu": {
                    k_: b * s / (spread(v)["median"] / 1e3) * fpt
                    / BF16_FLOPS_PER_S for k_, v in alt.items()},
                # both rows' weights and optimizer states resident
                "alternated_peak_over_start_gb": {
                    k_: max(v) - start_gb for k_, v in peak.items()},
                "alternated_runs_ms": alt, "nvidia_smi": smi,
                "step_profile": prof}

    _phase("train-1b", train_1b)

    # -- the model train-1b trained, served --------------------------------
    model_launches = {}

    def serve_model_1b():
        """ServingEngine(model, weight_dtype="int4", block_size=64) on both
        schedulers, graphs captured as first used and then sealed: the
        float32 routes of the three serving kernels at llama_1b width."""
        model = one_b.get("model")
        if model is None:                   # --only: an untrained model
            model = llama_1b_row()[0].eval()
        cfg1 = model.cfg
        L = cfg1.num_hidden_layers
        reqs = dense_requests(cfg1.vocab_size)
        kw = dict(weight_dtype="int4", block_size=64, num_blocks=160,
                  max_batch_size=8, chunk_size=8, prefill_chunk=256, seed=0)
        out, engines = {}, {}
        for name in ("ragged", "dense"):
            t0 = time.perf_counter()
            eng = ServingEngine(model, ragged=name == "ragged", **kw)
            build_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved()
            _require(eng.dec.cache.k[0][0].dtype == torch.float32,
                     f"a bf16 model's decoder pool is "
                     f"{eng.dec.cache.k[0][0].dtype}, JAX's is float32")
            first, _, _ = drive(eng, reqs)          # captures as first used
            capture = lazy_capture(eng, mem0)
            outs, wall, st, launched = drive_checked(
                eng, reqs, f"serve-model-1b {name}")
            model_launches[name] = launched
            for (p, t), a, b_ in zip(reqs, first, outs):
                _require(t > 0 or np.array_equal(a, b_),
                         f"{name}: a greedy stream differs between two runs")
            pool = L * 2 * 160 * cfg1.num_key_value_heads * 64 \
                * (cfg1.hidden_size // cfg1.num_attention_heads) * 4
            _require(st["kv_pool_bytes"] == pool and st["kv_quant"]
                     == "float32", f"{name}: pool {st['kv_quant']} "
                                   f"{st['kv_pool_bytes']} bytes, expected "
                                   f"float32 {pool}")
            if name == "ragged":
                one, step_ms, prof = decode_ministep(eng.dec)
                want = {"ragged_paged_attention": L,
                        "decode_matmul": 4 * L + 1}
                step_fn = lambda: decode_ministep(eng.dec,  # noqa: E731
                                                  profile=False)
            else:
                one, step_ms, prof = dense_decode_step(eng.dec)
                one = {k_: v for k_, v in one.items() if v}
                want = {"paged_attention_decode": L,
                        "decode_matmul": 4 * L + 1}
                gids = max((p for p, _ in reqs), key=len)[None, :256]

                def step_fn(dec=eng.dec, gids=gids):
                    dense_decode_step(dec, profile=False)
                    dec.generate(gids, 4)
            _require(one == want, f"{name}: one decode step launched {one}, "
                                  f"expected {want}")
            routes = _routes(torch, step_fn)
            _require(all("cuda-core" in r_ for r_ in routes)
                     and all(routes.get(f"{k_} cuda-core", 0) > 0
                             for k_ in path_kernels(name == "ragged")),
                     f"{name}: float32 serving took the routes {routes}")
            out[name] = {
                "build_s": build_s, "capture": capture,
                "tok_per_s": st["generated_tokens"] / wall,
                "wall_s": wall, "generated_tokens": st["generated_tokens"],
                **{k_: st[k_] for k_ in (
                    "ttft_p50_s", "ttft_p99_s", "latency_p50_s",
                    "latency_p99_s", "itl_p50_s", "itl_p99_s",
                    "queue_wait_p50_s", "kv_quant", "kv_pool_bytes",
                    "kv_bytes_per_token", "device_dispatches")},
                "launches": launched, "routes": routes,
                "decode_step_launches": one, "decode_step_wall_ms": step_ms,
                "decode_step_device_ms": prof["device_ms"],
                "decode_step_idle_share": prof["idle_share"],
                "decode_step_by_family": prof["device_ms_by_family"]}
            engines[name] = eng
        for eng in engines.values():
            eng.close()
        del engines
        # weight_dtype=None (float32 products, the model's tensors shared)
        # against the model's own generate() (bf16 activations) on two
        # greedy prompts: equal, or parted at a near-tie, a gap within
        # twice the difference of the two computations' logits there
        eng = ServingEngine(model, ragged=True, block_size=64,
                            num_blocks=64, max_batch_size=8, chunk_size=8,
                            prefill_chunk=256, cuda_graphs=False)
        pair = [p for p, t in reqs if t == 0][:2]
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=32))
                for p in pair]
        eng.run_to_completion()
        checks = []
        for p, rid in zip(pair, rids):
            a = eng.result(rid)
            b_ = model.generate(torch.as_tensor(p[None]),
                                max_new_tokens=32)[0, len(p):].cpu().numpy()
            i = next((j for j, (x, y) in enumerate(zip(a, b_)) if x != y),
                     None)
            if i is None:
                checks.append({"equal": True, "tokens": len(a)})
                continue
            toks = np.concatenate([p, a[:i]]).astype(np.int32)
            f32 = last_logits(eng.dec, toks, len(toks))
            # generate()'s own logits there: its cached forward over the
            # context in one prefill
            ids1, _, _, _, caches = _setup_decode(model, toks[None], 1, None)
            with torch.no_grad():
                bf = model(ids1, caches=caches, pos=0)[0][0, -1].float()
            gap = float(f32[int(a[i])] - f32[int(b_[i])])
            noise = float((f32 - bf).abs().max())
            _require(abs(gap) <= 2 * noise,
                     f"the float32 engine and generate() part at token {i} "
                     f"with a logit gap {gap}, beyond twice the noise "
                     f"{noise}")
            checks.append({"equal": False, "first_divergence": i,
                           "gap": gap, "noise": noise})
        eng.close()
        return {"model": "llama_1b as train-1b left it; int4 weights, float32 "
                         "activations and pool (the embedding's dtype, as "
                         "in JAX), block 64, 160 blocks",
                "requests": "serve-dense-int4's lengths (8 of 100-512 "
                            "tokens), 32 new, 6 greedy, 2 at 0.8",
                **out, "f32_engine_vs_generate": checks, "nvidia_smi": smi}

    _phase("serve-model-1b", serve_model_1b)
    one_b.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # -- the GPT / ERNIE family: multi-head attention (group 1) ---------------
    gpt_launches = {}

    def tiny_gpt_parity():
        """gpt_tiny(hidden_size=256) (head_dim 64, 4 heads = 4 kv heads)
        float32 with int4 weights, the same weights on the card (graphs,
        captured as used) and the CPU: both engines' greedy streams and
        generate() equal, one prefill's logits within 1e-3; the card ran
        the ragged, paged-decode, flash forward and GEMV kernels."""
        gcfg = gpt_tiny(hidden_size=256)
        cpu, gpu = cpu_and_card(gcfg, cls=PagedGPTDecoder)
        rng = np.random.RandomState(8)
        prompts = [rng.randint(0, gcfg.vocab_size, n) for n in (5, 12, 30)]
        ids = rng.randint(0, gcfg.vocab_size, (2, 16))
        res = {}
        reset_dense()
        for name, dec in (("cpu", cpu), ("card", gpu)):
            outs = []
            for ragged in (True, False):
                eng = ServingEngine(dec, ragged=ragged, max_batch_size=3,
                                    chunk_size=4, prefill_chunk=8,
                                    prompt_buckets=(8, 16, 32))
                rids = [eng.add_request(p, SamplingParams(max_new_tokens=8))
                        for p in prompts]
                eng.run_to_completion()
                errors = [eng.request(r).error for r in rids]
                _require(all(e is None for e in errors),
                         f"tiny-gpt-parity {name} "
                         f"{'ragged' if ragged else 'dense'}: {errors}")
                outs.append([eng.result(r).tolist() for r in rids])
                eng.close()
                dec.cache.debug_check()
            res[name] = (outs, dec.generate(ids, max_new_tokens=8).tolist())
        launched = dense_counts()
        gpt_launches["tiny-gpt-parity"] = dict(launched)
        _require(all(v > 0 for v in launched.values()),
                 f"tiny-gpt-parity did not launch every kernel: {launched}")
        row = rng.randint(0, gcfg.vocab_size, (1, 16))
        logits = []
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
        _require(err < 1e-3, f"tiny-gpt-parity prefill logits differ by "
                             f"{err}")
        _require(res["cpu"] == res["card"],
                 f"tiny-gpt-parity card and CPU differ: {res}")
        return {"tokens_equal": True, "generate_equal": True,
                "prefill_logits_max_abs_err": err, "launches": launched}

    _phase("tiny-gpt-parity", tiny_gpt_parity)

    def serve_ernie_int4():
        """ernie_45_dense_3b at full width and all 28 layers, int4 weights
        from from_config(seed=0) (made and quantized layer by layer on
        the card), bf16 activations and pool (160 blocks of 64), served by
        the ragged and the dense engine as CUDA graphs: 8 greedy requests
        of 64..512 prompt tokens, 64 new each. Each engine's first run
        captures the keys it uses, then the set is sealed and a second
        run is held to the launches its dispatches call for and no
        recompile; the two schedulers' streams equal or a near-tie. Then
        a W 8 ministep and a dense decode step at ctx 512 (launches and
        device ms), and an eager run on an int8 pool over the same
        weights, whose GEMV launches are counted by weight where the
        kernel launches."""
        ecfg = ernie_45_dense_3b(dtype="bfloat16")
        L = ecfg.num_hidden_layers
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        edec = PagedGPTDecoder.from_config(ecfg, seed=0, weight_dtype="int4",
                                           block_size=64, num_blocks=160,
                                           device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        erng = np.random.RandomState(14)
        reqs = [(erng.randint(0, ecfg.vocab_size, int(n)),
                 {"max_new_tokens": 64, "temperature": 0.0})
                for n in erng.randint(64, 513, 8)]
        info = {"model": "ernie_45_dense_3b int4 (halves), bf16 pool, 28 "
                         "layers, 20 heads = 20 kv heads, d 128",
                "load_s": load_s, "load_peak_mem_gb": load_peak_gb,
                "prompt_lens": [len(p) for p, _ in reqs]}
        outs = {}
        for name, ragged in (("ragged", True), ("dense", False)):
            mem0 = torch.cuda.memory_reserved()
            eng = engine(edec, ragged, graphs=True)
            t0 = time.perf_counter()
            first, _, _ = drive(eng, reqs)
            capture_s = time.perf_counter() - t0
            cap = lazy_capture(eng, mem0)
            got, wall, st, launched = drive_checked(
                eng, reqs, f"serve-ernie-int4 {name}")
            for a, b_ in zip(first, got):
                _require(np.array_equal(a, b_),
                         f"serve-ernie-int4 {name}: the sealed run's tokens "
                         f"differ from the capturing run's")
            gpt_launches[name] = dict(launched)
            outs[name] = got
            info[name] = {
                "tok_per_s": st["generated_tokens"] / wall,
                "generated_tokens": st["generated_tokens"],
                "wall_s": wall, "ttft_p50_s": st["ttft_p50_s"],
                "ttft_p99_s": st["ttft_p99_s"], "itl_p50_s": st["itl_p50_s"],
                "itl_p99_s": st["itl_p99_s"],
                "device_dispatches": st["device_dispatches"],
                "launches": launched, "capture_run_s": capture_s,
                "capture": cap,
                "unexpected_recompiles": st["unexpected_recompiles"]}
            eng.close()
            del eng
            torch.cuda.empty_cache()
        info["first_divergences"] = greedy_gaps(
            edec, reqs, outs["ragged"], outs["dense"],
            "serve-ernie-int4 ragged vs dense")
        one, wall_ms, prof = decode_ministep(edec)
        _require(one == {"ragged_paged_attention": L,
                         "decode_matmul": 4 * L + 1},
                 f"serve-ernie-int4: a W 8 ministep launched {one}, "
                 f"expected {L} attention and {4 * L + 1} GEMV kernels")
        done, dwall_ms, dprof = dense_decode_step(edec)
        _require(done["paged_attention_decode"] == L
                 and done["decode_matmul"] == 4 * L + 1,
                 f"serve-ernie-int4: a dense decode step launched {done}")
        weight_bytes = sum(
            (w.q.numel() + w.scale.numel() * 4) if isinstance(w, QWeight)
            else 0 for lw in edec.weights[0]["layers"] for w in lw.values()) \
            + edec.weights[0]["head"].q.numel() \
            + edec.weights[0]["head"].scale.numel() * 4
        kv_bytes = 8 * 513 * edec.cache.bytes_per_token()
        info.update({
            "ministep_W8_ctx512": {"launches": one, "wall_ms": wall_ms,
                                   "device_ms": prof["device_ms"],
                                   "idle_share": prof["idle_share"],
                                   "device_ms_by_family":
                                       prof["device_ms_by_family"]},
            "dense_step_b8_ctx512": {"launches": done, "wall_ms": dwall_ms,
                                     "device_ms": dprof["device_ms"],
                                     "idle_share": dprof["idle_share"],
                                     "device_ms_by_family":
                                         dprof["device_ms_by_family"]},
            "weight_bytes": weight_bytes, "kv_bytes_w8_ctx512": kv_bytes,
            "ministep_bound_ms": 1e3 * (weight_bytes + kv_bytes)
            / HBM_BYTES_PER_S,
            "pool_bytes_per_token": edec.cache.bytes_per_token()})
        # the int8 pool at group 1 on the same weights, eager, ragged
        kdec = PagedGPTDecoder(ecfg, edec.weights[0], weight_dtype="int4",
                               kv_quant="int8", block_size=64,
                               num_blocks=160, device="cuda")
        eng = engine(kdec, True)
        reset_dense()
        kouts, kwall, kst = drive(eng, reqs[:4])
        # the eager leg's GEMV launches by weight, counted where the
        # kernel launches
        by_shape = dict(dmm.launches_by_shape)
        gemv = {n_: by_shape.get(s_, 0) for n_, s_ in SHAPES_ERNIE.items()}
        gpt_launches["int8_pool"] = dense_counts()
        gpt_launches["int8_pool_gemv"] = gemv
        _require(gpt_launches["int8_pool"]["ragged_paged_attention"] > 0
                 and all(gemv.values()) and sum(by_shape.values())
                 == gpt_launches["int8_pool"]["decode_matmul"],
                 f"serve-ernie-int4 int8 pool: launched "
                 f"{gpt_launches['int8_pool']}, GEMV by shape {by_shape}")
        # reported, not held: int8 pages round K and V (the CPU tests
        # hold the int8 pool to JAX's on the same pools)
        info["int8_pool"] = {
            "tok_per_s": kst["generated_tokens"] / kwall,
            "launches": gpt_launches["int8_pool"],
            "gemv_launches_by_weight": gemv,
            "tokens_equal_bf16_pool": [
                int((a == b_).sum()) for a, b_ in zip(outs["ragged"][:4],
                                                      kouts)]}
        eng.close()
        del eng, kdec, edec
        gc.collect()
        torch.cuda.empty_cache()
        return info

    _phase("serve-ernie-int4", serve_ernie_int4)

    def train_gpt_345m():
        """gpt_345m in bf16 (float32 weights, tied head), b 8 x s 1024,
        AdamW(1e-4, weight_decay=0.01): 1 warm and 5 timed TrainSteps;
        exactly 24 launches of each flash kernel a step, no serving
        kernel; every loss finite and the last below the first. Step
        ms, tokens/s, MFU (bench.py's formula over 989 TFLOP/s), peak
        memory and the device time by family."""
        tcfg = gpt_345m(dtype="bfloat16")
        b, s, warm, iters = 8, 1024, 1, 5
        model = GPTForCausalLM(tcfg, seed=0, device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, model.loss, opt)
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, tcfg.vocab_size, size=(b, s)).astype(np.int32), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_flash()
        losses = [step(ids, ids) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids, ids) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = flash_counts()
        gpt_launches["train"] = dict(launched)
        L = tcfg.num_hidden_layers
        n_steps = warm + iters
        _require(launched == {k_: L * n_steps for k_ in launched},
                 f"train-gpt-345m: {n_steps} steps launched {launched}")
        _require(all(v == 0 for v in counts().values()),
                 f"train-gpt-345m launched serving kernels: {counts()}")
        losses = [float(x) for x in losses]
        _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                 f"train-gpt-345m losses {losses}")
        step_ms = wall * 1e3 / iters
        tok_s = b * s * iters / wall
        n_params = model.num_params()
        fpt = 6 * n_params + 12 * L * tcfg.hidden_size * s
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = _device_breakdown(torch, lambda: step(ids, ids), step_ms)
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return {"model": "gpt_345m bf16 compute (float32 weights), 24 "
                         "layers, 16 heads = 16 kv heads, d 64, b8 x s1024",
                "num_params": n_params, "launches": launched,
                "steps": n_steps, "losses": losses, "step_ms": step_ms,
                "tokens_per_s": tok_s,
                "mfu": tok_s * fpt / BF16_FLOPS_PER_S,
                "flops_per_token": fpt, "peak_mem_gb": peak_gb,
                "step_profile": prof}

    _phase("train-gpt-345m", train_gpt_345m)

    # -- DiT: Conv2D patchify, adaLN-Zero blocks, attention at head_dim 72 --
    dit_launches = {}

    def tiny_dit_parity():
        """DiT at head_dim 72 (hidden 144 over 2 heads) and 64 (128 over
        2), depth 2, on the card and the CPU from the same weights, every
        one drawn N(0, 0.02) (at the model's own init adaLN-Zero makes
        the output 0): float32 and bf16 outputs within 1e-3 / 1e-2 of the
        largest |out|, three TrainSteps' losses within 1e-3 / 1e-2
        relative; each card run launches exactly its depth of each flash
        kernel a step (and of the forward an eval forward)."""
        out = {}
        for d, hid in ((72, 144), (64, 128)):
            for dtype, tol in (("float32", 1e-3), ("bfloat16", 1e-2)):
                dcfg = dit_tiny(hidden_size=hid, num_heads=2,
                                class_dropout_prob=0.0, learn_sigma=False,
                                dtype=dtype)
                cpu = DiT(dcfg, seed=3, device="cpu")
                g = torch.Generator().manual_seed(4)
                with torch.no_grad():
                    for p_ in cpu.parameters():
                        p_.normal_(0.0, 0.02, generator=g)
                gpu = DiT(dcfg, seed=0, device="cuda")
                gpu.load_numpy_state({n: p_.detach().numpy()
                                      for n, p_ in cpu.named_parameters()})
                rng = np.random.RandomState(5)
                arrays = (rng.randn(4, 4, 8, 8).astype(np.float32),
                          rng.randint(0, 1000, 4).astype(np.int32),
                          rng.randint(0, 10, 4).astype(np.int32),
                          rng.randn(4, 4, 8, 8).astype(np.float32))
                dt = getattr(torch, dtype)
                outs, losses = [], []
                for m in (cpu, gpu):
                    dev = next(m.parameters()).device
                    x, t, y, noise = (torch.as_tensor(a, device=dev)
                                      for a in arrays)
                    x, noise = x.to(dt), noise.to(dt)
                    if dev.type == "cuda":
                        reset_flash()
                    m.eval()
                    with torch.no_grad():
                        outs.append(m(x, t, y).float().cpu())
                    m.train()
                    step = TrainStep(m, F.mse_loss, AdamW(
                        learning_rate=1e-3, parameters=m.parameters()))
                    losses.append([float(step((x, t, y), noise))
                                   for _ in range(3)])
                launched = flash_counts()
                L = dcfg.depth
                _require(launched == {"flash_fwd": 4 * L,
                                      "flash_bwd_dq": 3 * L,
                                      "flash_bwd_dkv": 3 * L},
                         f"tiny-dit-parity d {d} {dtype}: a forward and "
                         f"3 steps launched {launched}")
                scale = float(outs[0].abs().max())
                err = float((outs[0] - outs[1]).abs().max())
                rel = max(abs(a - b_) / abs(a) for a, b_ in zip(*losses))
                _require(scale > 1e-3 and err <= tol * scale,
                         f"tiny-dit-parity d {d} {dtype}: output differs "
                         f"by {err} of {scale}")
                _require(rel < tol, f"tiny-dit-parity d {d} {dtype}: "
                                    f"losses cpu {losses[0]} vs cuda "
                                    f"{losses[1]}")
                key = f"d{d}_{dtype}"
                dit_launches[key] = launched
                out[key] = {"max_abs_err": err, "max_abs_out": scale,
                            "losses_cpu": losses[0],
                            "losses_cuda": losses[1],
                            "loss_max_rel_diff": rel, "launches": launched}
        return out

    _phase("tiny-dit-parity", tiny_dit_parity)

    def train_dit_xl2():
        """bench.py's dit row: DiT-XL/2 in bf16 (float32 weights), b 32
        on [32, 4, 32, 32] latents, label dropout 0.1, AdamW(1e-4),
        F.mse_loss to the noise: 2 warm and 8 timed TrainSteps; exactly
        28 launches of each flash kernel (d 72) a step, no serving
        kernel; every loss finite and the last below the first. Step
        ms, imgs/s, MFU (bench.py's formula over 989 TFLOP/s), peak
        memory and the device time by family."""
        dcfg = dit_xl_2(dtype="bfloat16", learn_sigma=False)
        b, warm, iters = 32, 2, 8
        t0 = time.perf_counter()
        model = DiT(dcfg, seed=0, device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        step = TrainStep(model, F.mse_loss, opt)
        # as bench.py draws them, in its order
        rng = np.random.RandomState(0)
        x = torch.as_tensor(rng.randn(b, 4, 32, 32).astype(np.float32),
                            device="cuda").to(torch.bfloat16)
        t = torch.as_tensor(rng.randint(0, 1000, b).astype(np.int32),
                            device="cuda")
        y = torch.as_tensor(rng.randint(0, dcfg.num_classes, b)
                            .astype(np.int32), device="cuda")
        noise = torch.as_tensor(rng.randn(b, 4, 32, 32).astype(np.float32),
                                device="cuda").to(torch.bfloat16)
        drop = torch.Generator(device="cuda")
        drop.manual_seed(0)
        inputs = (x, t, y, drop)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_flash()
        losses = [step(inputs, noise) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(inputs, noise) for _ in range(iters)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = flash_counts()
        dit_launches["train"] = dict(launched)
        L, n_steps = dcfg.depth, warm + iters
        _require(launched == {k_: L * n_steps for k_ in launched},
                 f"train-dit-xl2: {n_steps} steps launched {launched}, "
                 f"expected {L} of each flash kernel a step")
        _require(all(v == 0 for v in counts().values()),
                 f"train-dit-xl2 launched serving kernels: {counts()}")
        losses = [float(v) for v in losses]
        _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                 f"train-dit-xl2 losses {losses}")
        step_ms = wall * 1e3 / iters
        imgs_s = b * iters / wall
        n_params = model.num_params()
        T = (dcfg.input_size // dcfg.patch_size) ** 2
        fpi = 6 * n_params * T + 12 * L * dcfg.hidden_size * T ** 2
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = _device_breakdown(torch, lambda: step(inputs, noise),
                                 step_ms)
        # the profiled step's flash launches are the Hopper kernels' at 72
        routed = {n: c for n, (c, _ms) in prof["flash_kernels"].items()
                  if "piece_sum" not in n}
        _require(routed == {f"flash_wg::{k}_kernel<bf16,72>": L
                            for k in ("fwd", "dq", "dkv")},
                 f"train-dit-xl2: a step's flash kernels were {routed}")
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return {"model": "DiT-XL/2 bf16 compute (float32 weights), 28 "
                         "layers, 16 heads of 72, b32 x 256 patches, "
                         "AdamW(1e-4)",
                "num_params": n_params, "init_s": init_s,
                "launches": launched, "steps": n_steps, "losses": losses,
                "step_ms": step_ms, "imgs_per_s": imgs_s,
                "mfu": imgs_s * fpi / BF16_FLOPS_PER_S,
                "flops_per_img": fpi, "peak_mem_gb": peak_gb,
                "nvidia_smi": smi, "step_profile": prof}

    _phase("train-dit-xl2", train_dit_xl2)

    # -- MoE: GShard (dense) and dropless (ragged) dispatch, aux loss --------
    moe_launches = {}

    def record_routing(model, record):
        """Forward pre-hooks that record each MoE layer's tokens' top-k
        expert sets (from the layer's input and router, in float32);
        returns the hooks' handles."""
        handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, MoELayer):
                def hook(mod, args, name=name):
                    x = args[0]
                    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                          @ mod.gate_weight.float(), dim=-1)
                    top = torch.sort(probs, dim=-1, descending=True,
                                     stable=True).indices[:, :mod.top_k]
                    record[name] = top.sort(dim=-1).values.cpu()
                handles.append(mod.register_forward_pre_hook(hook))
        return handles

    def check_moe_sync_free(model):
        """One forward and backward of the model's last MoE layer on a
        bf16 input with CUDA sync debugging set to raise: the card's bf16
        route reads nothing on the host, or the phase fails."""
        layer = model.model.layers[-1].mlp.moe
        x = torch.randn(2, 64, layer.d_model, device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)

        def run():
            out = layer(x)
            (out.float().square().mean() + layer.aux_loss).backward()

        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()

    def tiny_moe_parity():
        """moe_tiny widened to head_dim 64 (hidden 256, 4 / 2 heads; the
        card's flash kernels take it), the same numpy state on the card
        and the CPU, dense and ragged dispatch. float32: logits within
        1e-4 of the largest |logit|, five TrainSteps of AdamW(1e-3) with
        losses within 1e-5 relative, 5 launches of each flash kernel a
        layer (forward + 5 steps: 6 forwards). bf16: the share of tokens whose top-k
        experts agree between card and CPU, those tokens' logits within
        1e-2 of the largest |logit|, and the MoE layer's forward and
        backward on the card with no host sync."""
        out = {}
        b, s = 2, 64
        ids = np.random.RandomState(5).randint(0, 512, (b, s)).astype(
            np.int32)
        for mode in ("dense", "ragged"):
            for dtype in ("float32", "bfloat16"):
                mcfg = moe_tiny(hidden_size=256, num_attention_heads=4,
                                num_key_value_heads=2, dtype=dtype,
                                moe_dispatch_mode=mode)
                cpu = MoEForCausalLM(mcfg, seed=3, device="cpu")
                gpu = MoEForCausalLM(mcfg, seed=0, device="cuda")
                gpu.load_state_dict(cpu.state_dict())
                logits, routes, losses = [], [], []
                for m in (cpu, gpu):
                    dev = next(m.parameters()).device
                    x = torch.as_tensor(ids, device=dev)
                    if dev.type == "cuda":
                        reset_flash()
                    record = {}
                    handles = record_routing(m, record)
                    with torch.no_grad():
                        logits.append(m(x).float().cpu())
                    for h_ in handles:
                        h_.remove()
                    routes.append(record)
                    if dtype == "float32":
                        step = TrainStep(m, m.loss, AdamW(
                            learning_rate=1e-3, parameters=m.parameters()))
                        losses.append([float(step(x, x)) for _ in range(5)])
                launched = flash_counts()
                agree = {name: float((routes[0][name] == routes[1][name])
                                     .all(-1).float().mean())
                         for name in routes[0]}
                scale = float(logits[0].abs().max())
                err = float((logits[0] - logits[1]).abs().max())
                key = f"{mode}_{dtype}"
                info = {"routing_agreement": agree, "max_abs_err": err,
                        "max_abs_logit": scale, "launches": launched}
                L = mcfg.num_hidden_layers
                if dtype == "float32":
                    rel = max(abs(a - b_) / abs(a)
                              for a, b_ in zip(*losses))
                    _require(launched == {"flash_fwd": 6 * L,
                                          "flash_bwd_dq": 5 * L,
                                          "flash_bwd_dkv": 5 * L},
                             f"tiny-moe-parity {key}: launched {launched}")
                    _require(err <= 1e-4 * scale,
                             f"tiny-moe-parity {key}: logits differ by "
                             f"{err} of {scale}")
                    _require(rel < 1e-5, f"tiny-moe-parity {key}: losses "
                                         f"cpu {losses[0]} vs cuda "
                                         f"{losses[1]}")
                    info.update(losses_cpu=losses[0], losses_cuda=losses[1],
                                loss_max_rel_diff=rel)
                else:
                    _require(launched == {"flash_fwd": L, "flash_bwd_dq": 0,
                                          "flash_bwd_dkv": 0},
                             f"tiny-moe-parity {key}: launched {launched}")
                    # the only MoE layer is the last: a token's routing
                    # reaches no other token's logits, so the tokens
                    # whose top-k sets agree are held
                    (name,) = routes[0]
                    same = (routes[0][name] == routes[1][name]).all(-1)
                    held = float((logits[0] - logits[1]).abs().reshape(
                        b * s, -1)[same].max())
                    _require(held <= 1e-2 * scale,
                             f"tiny-moe-parity {key}: logits of tokens "
                             f"routed alike differ by {held} of {scale}")
                    check_moe_sync_free(gpu)
                    info.update(held_tokens=int(same.sum()),
                                held_max_abs_err=held, ffn_sync_free=True)
                moe_launches[f"tiny_{key}"] = launched
                out[key] = info
        return out

    _phase("tiny-moe-parity", tiny_moe_parity)

    # bench.py's moe rows (bench.py:278-318, :409-431)
    MOE_ROWS = {
        "moe_dense": dict(mode="dense"),
        "moe_ragged": dict(mode="ragged"),
        "moe_ragged_e64": dict(mode="ragged", num_experts=64,
                               moe_intermediate=512),
        "moe_ragged_wide": dict(mode="ragged", hidden=2048,
                                moe_intermediate=2048, intermediate=4096,
                                moment_dtype="bfloat16")}

    def grouped_products():
        """ops.moe._grouped_mm (torch._grouped_mm) in bf16 at the expert
        geometry of each row: 16,384 routed rows (b 4 x s 2048, top-2)
        cut by a seeded top-2 routing of random logits with expert 0
        given no row. The product and its autograd dX and dW against a
        float32 matmul per expert on the same values: the largest error
        over the largest |reference|, each within 1e-2."""
        rows, out = 16384, {}
        rng = np.random.RandomState(0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, d, h, e in (("e8_h1408", 1024, 1408, 8),
                              ("e64_h512", 1024, 512, 64),
                              ("e8_h2048_wide", 2048, 2048, 8)):
            logits = rng.randn(rows // 2, e).astype(np.float32)
            logits[:, 0] = -1e9
            top = np.argsort(-logits, axis=1, kind="stable")[:, :2]
            host = np.bincount(top.reshape(-1), minlength=e).tolist()
            sizes = torch.tensor(host, device="cuda")
            x, w, dy = (
                (torch.randn(*shape, device="cuda", generator=gen) * sc)
                .to(torch.bfloat16)
                for shape, sc in (((rows, d), 0.5), ((e, d, h), d ** -0.5),
                                  ((rows, h), 1.0)))
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = moe_ops._grouped_mm(xg, wg, sizes)
            y.backward(dy)
            xr, wr = (t.float().requires_grad_() for t in (x, w))
            yr = torch.cat([part @ wr[i] for i, part in
                            enumerate(torch.split(xr, host))])
            yr.backward(dy.float())
            err = {}
            for key, got, ref in (("y", y, yr), ("dx", xg.grad, xr.grad),
                                  ("dw", wg.grad, wr.grad)):
                err[key] = float((got.detach().float() - ref.detach())
                                 .abs().max() / ref.detach().abs().max())
                _require(err[key] <= 1e-2,
                         f"train-moe grouped product {name}: {key} "
                         f"differs by {err[key]} of its largest value")
            out[name] = {"d": d, "h": h, "e": e, "rows": rows,
                         "rel_err": err}
            del x, w, dy, xg, wg, xr, wr, y, yr
        torch.cuda.empty_cache()
        return out

    def train_moe():
        """bench.py's four moe rows as it builds them: MoEConfig(dtype=
        "bfloat16", 8 layers, 16 heads over 8 kv heads, top-2, one
        shared expert, chunked CE 1024, max_position_embeddings 2048),
        b 4 x s 2048 from RandomState(0), AdamW(1e-4,
        weight_decay=0.01): 2 warm and 8 timed TrainSteps. The flash
        counters, set to 0 just before and read just after, must read 8
        of each kernel a step, and a traced step must hold 8 of each of
        the three Hopper kernels at head_dim 64 (128 for the wide row)
        and no other flash kernel; no serving kernel; every loss finite and the last
        below the first. Step ms, tokens/s, activated MFU (bench.py's
        formula over 989 TFLOP/s), total and activated parameters, peak
        memory, device ms by family and the idle share; the dense row's
        dropped fraction from one eager forward. First the grouped
        product at each row's expert geometry (grouped_products)."""
        b, s, warm, iters = 4, 2048, 2, 8
        out = {"nvidia_smi": smi, "grouped_products": grouped_products()}
        for tag, r in MOE_ROWS.items():
            mcfg = MoEConfig(
                dtype="bfloat16", hidden_size=r.get("hidden", 1024),
                intermediate_size=r.get("intermediate", 2816),
                moe_intermediate_size=r.get("moe_intermediate", 1408),
                num_hidden_layers=8, num_attention_heads=16,
                num_key_value_heads=8, num_experts=r.get("num_experts", 8),
                num_experts_per_tok=2, max_position_embeddings=2048,
                chunked_ce_tokens=1024, moe_dispatch_mode=r["mode"])
            t0 = time.perf_counter()
            model = MoEForCausalLM(mcfg, seed=0, device="cuda")
            opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                        weight_decay=0.01, moment_dtype=r.get("moment_dtype"))
            step = TrainStep(model, model.loss, opt)
            ids = torch.as_tensor(np.random.RandomState(0).randint(
                0, mcfg.vocab_size, size=(b, s)).astype(np.int32),
                device="cuda")
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
            launched = flash_counts()
            L, n_steps = mcfg.num_hidden_layers, warm + iters
            moe_launches[tag] = dict(launched)
            _require(launched == {k_: L * n_steps for k_ in launched},
                     f"train-moe {tag}: {n_steps} steps launched "
                     f"{launched}, expected {L} of each flash kernel a step")
            _require(all(v == 0 for v in counts().values()),
                     f"train-moe {tag} launched serving kernels: {counts()}")
            losses = [float(v) for v in losses]
            _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                     f"train-moe {tag} losses {losses}")
            step_ms = wall * 1e3 / iters
            tok_s = b * s * iters / wall
            n_params = model.num_params()
            n_act = model.num_activated_params()
            hd = mcfg.hidden_size // mcfg.num_attention_heads
            fpt = 6 * n_act + 12 * L * mcfg.num_attention_heads * hd * s
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            want = {f"flash_wg::{k}_kernel<bf16,{hd}>": L
                    for k in ("fwd", "dq", "dkv")}
            # a trace is whole once a pad was recorded (_kernel_events);
            # one more step, with more pads, while none was
            for pads in (_PAD_LAUNCHES, 32768, 131072):
                prof = _device_breakdown(torch, lambda: step(ids, ids),
                                         step_ms, pads)
                if prof["pad_records_lost"] is not None:
                    break
            _require(prof["pad_records_lost"] is not None,
                     f"train-moe {tag}: the profiler lost all {pads} pad "
                     f"records of a traced step")
            traced = {n: c for n, (c, _ms) in prof["flash_kernels"].items()
                      if "piece_sum" not in n}
            _require(traced == want,
                     f"train-moe {tag}: a traced step's flash kernels were "
                     f"{traced}, not {want}")
            row = {"dispatch": r["mode"], "hidden": mcfg.hidden_size,
                   "experts": mcfg.num_experts,
                   "moe_intermediate": mcfg.moe_intermediate_size,
                   "moment_dtype": r.get("moment_dtype") or "float32",
                   "num_params": n_params, "num_activated_params": n_act,
                   "init_s": init_s, "launches": launched,
                   "flash_launches_per_step": {
                       k_: v // n_steps for k_, v in launched.items()},
                   "steps": n_steps, "losses": losses, "step_ms": step_ms,
                   "tokens_per_s": tok_s,
                   "mfu_activated": tok_s * fpt / BF16_FLOPS_PER_S,
                   "flops_per_token": fpt, "peak_mem_gb": peak_gb,
                   "traced_flash_launches": traced, "step_profile": prof}
            if r["mode"] == "dense":
                with torch.no_grad():
                    model(ids)
                row["dropped_fraction"] = [
                    float(lay.mlp.moe.routing_stats["dropped_fraction"])
                    for lay in model.model.layers if not lay.is_dense]
                row["capacity"] = float(
                    model.model.layers[-1].mlp.moe.routing_stats["capacity"])
            out[tag] = row
            del model, opt, step, losses
            gc.collect()
            torch.cuda.empty_cache()
        return out

    _phase("train-moe", train_moe)

    # -- last, as a capture that fails may leave the allocator unusable --
    def capture_failure():
        """A program that cannot be captured (a host sync inside it):
        its first dispatch raises, no graph is kept, and nothing runs it
        eagerly instead."""
        ps = ProgramSet("cuda", CompileWatch())
        ran = []

        def host_sync(key, x):
            ran.append(int(x.sum()))
            return (x * ran[-1],)

        ps.register("host_sync", host_sync)
        try:
            ps.run("host_sync", (4,), [np.ones(4, np.int32)])
            err = None
        except RuntimeError as e:
            err = str(e).splitlines()[0][:200]
        _require(err is not None and ps.captured == 0 and ran == [4],
                 f"a capture with a host sync inside did not raise "
                 f"(error {err!r}, {ps.captured} graphs, eager runs {ran})")
        _require(float(torch.ones(4, device="cuda").sum()) == 4.0,
                 "the card does not work after a failed capture")
        return {"raised": err}

    _phase("capture-failure", capture_failure)
    if _ONLY is not None:
        print(f"chip_smoke: ran only {sorted(_ONLY)}; no result",
              file=sys.stderr)
        return 0

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
        if key in ("bf16", "int4"):
            # the telemetry and fleet phases' launches of the same kernel
            fam = name.split("[")[0]
            kernel_rows[-1]["launches_by_phase"] = {
                ph: n[fam] for ph, n in fleet_launches.items()
                if ph != "tiny-fleet-parity"}
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
        # the same shape (b 4 x s 2048, 16 / 8 heads of 128) in train-moe's
        # wide row
        kernel_rows[-1]["launches_by_phase"] = {
            "train-moe moe_ragged_wide":
                moe_launches["moe_ragged_wide"][name]}
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
    for key, name, rep, src, launches in (
            ("f32_ragged", "ragged_paged_attention[float32]",
             tpu + "ragged_paged_attention.py:201",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             model_launches["ragged"]["ragged_paged_attention"]),
            ("f32_gemv", "decode_matmul[int4, float32 x]",
             tpu + "decode_matmul.py:135",
             "paddle_tpu_torch/csrc/decode_matmul.cu",
             model_launches["ragged"]["decode_matmul"]
             + model_launches["dense"]["decode_matmul"]),
            ("f32_decode", "paged_attention_decode[float32]",
             tpu + "paged_attention.py:125",
             "paddle_tpu_torch/csrc/paged_attention_decode.cu",
             model_launches["dense"]["paged_attention_decode"])):
        c = heads[key]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
        if key == "f32_decode":
            kernel_rows[-1]["launches_by_phase"] = {
                "tiny-fleet-parity":
                    fleet_launches["tiny-fleet-parity"][
                        "paged_attention_decode"]}
    f = heads["f32_flash"]
    kernel_rows.append({
        "name": "flash_fwd[float32]", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": tpu + "flash_attention.py:69",
        "launches": model_launches["dense"]["flash_fwd"],
        "max_abs_err": f["max_abs_err"]["fwd"], "ms": f["ms"]["fwd"],
        "plain_ms": f["plain_ms"]["fwd"], "bound_ms": f["bound_ms"]["fwd"],
        "bound_by": f["bound_by"]["fwd"],
        "library_ms": f["library_ms"]["fwd"],
        "launches_by_phase": {"tiny-fleet-parity": fleet_launches[
            "tiny-fleet-parity"]["flash_fwd"]}})
    # the kernels at a tp shard's shapes: their launches from
    # serve-tp2-int4's runs (fp32 comm eager; the int8-pool and tp-4
    # legs), the GEMV's by shard projection as counted at its launch
    # site (every row count up to 32; the row's times are at b 8)
    for key, name, run in (
            ("tp2_w8_ctx512", "ragged_paged_attention[tp2 shard, 16/4 "
             "heads]", "serve-tp2-int4 fp32"),
            ("tp2_int8_w8_ctx512", "ragged_paged_attention[tp2 shard, "
             "16/4 heads, int8 pool]", "serve-tp2-int4 tp2_kv8"),
            ("tp4_w8_ctx512", "ragged_paged_attention[tp4 shard, 8/2 "
             "heads]", "serve-tp2-int4 tp4")):
        c = heads[key]
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": tpu + "ragged_paged_attention.py:201",
            "launches": tp_launches[run]["ragged_paged_attention"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    gemv_by_shape = tp_launches["serve-tp2-int4 fp32"]["gemv_by_shape"]
    for name, shape in SHAPES_8B_TP2.items():
        c = heads[f"gemv_{name}"]
        kernel_rows.append({
            "name": f"decode_matmul[int4, {name}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_matmul.cu",
            "replaces": tpu + "decode_matmul.py:135",
            "launches": gemv_by_shape.get(shape, 0), "timed_rows": 8,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    # the kernels at group 1 (one query head per kv head), on the GPT /
    # ERNIE paths: launches from serve-ernie-int4's sealed runs (the
    # int8 pool and the GEMV by weight: its eager leg, counted at the
    # launch site) and train-gpt-345m's steps, times at b 8; the
    # prefill rung's (8 decode + 128 prefill rows) times ride on the W 8
    # row, which counts the kernel's launches at every row count
    rsrc = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    for key, name, launches in (
            ("ernie_w8_ctx512", "ragged_paged_attention[group 1, 20/20 "
             "heads]", gpt_launches["ragged"]["ragged_paged_attention"]),
            ("ernie_int8_w8_ctx512", "ragged_paged_attention[group 1, int8 "
             "pool]", gpt_launches["int8_pool"]["ragged_paged_attention"])):
        c = heads[key]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": rsrc,
            "replaces": tpu + "ragged_paged_attention.py:201",
            "launches": launches, "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
        if key == "ernie_w8_ctx512":
            c = heads["ernie_prefill_128"]
            kernel_rows[-1]["prefill_rung_8_decode_128_prefill"] = {
                k_: c[k_] for k_ in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}
    c = heads["ernie_decode"]
    kernel_rows.append({
        "name": "paged_attention_decode[group 1, 20/20 heads]",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention_decode.cu",
        "replaces": tpu + "paged_attention.py:125",
        "launches": gpt_launches["dense"]["paged_attention_decode"],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    for name in SHAPES_ERNIE:
        c = heads[f"gemv_{name}"]
        kernel_rows.append({
            "name": f"decode_matmul[int4, {name}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_matmul.cu",
            "replaces": tpu + "decode_matmul.py:135",
            "launches": gpt_launches["int8_pool_gemv"][name],
            "launches_from": "serve-ernie-int4 int8-pool eager leg",
            "timed_rows": 8,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    f = heads["gpt_flash"]
    for key, name, rep in (
            ("fwd", "flash_fwd[group 1, gpt_345m]",
             tpu + "flash_attention.py:69"),
            ("dq", "flash_bwd_dq[group 1, gpt_345m]",
             tpu + "flash_attention.py:174"),
            ("dkv", "flash_bwd_dkv[group 1, gpt_345m]",
             tpu + "flash_attention.py:229")):
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_wg.cu",
            "replaces": rep,
            "launches": gpt_launches["train"][name.split("[")[0]],
            "max_abs_err": f["max_abs_err"][key], "ms": f["ms"][key],
            "plain_ms": f["plain_ms"][key], "bound_ms": f["bound_ms"][key],
            "bound_by": f["bound_by"][key],
            "library_ms": f["library_ms"][key]})
        if key == "fwd":
            kernel_rows[-1]["launches_by_phase"] = {
                "serve-ernie-int4 dense prefill":
                    gpt_launches["dense"]["flash_fwd"]}
    # head_dim 72: DiT-XL/2's attention, bf16 with train-dit-xl2's
    # launches (the Hopper kernels); float32 (CUDA cores) timed at the
    # same shape, launched by tiny-dit-parity's float32 d 72 run
    for key, dtn, launches in (
            ("dit_xl2", "d 72, DiT-XL/2", dit_launches["train"]),
            ("f32_dit_xl2", "float32, d 72",
             dit_launches["d72_float32"])):
        f = heads[key]
        for kk, name, rep in (
                ("fwd", "flash_fwd", tpu + "flash_attention.py:69"),
                ("dq", "flash_bwd_dq", tpu + "flash_attention.py:174"),
                ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:229")):
            hopper = key == "dit_xl2"
            kernel_rows.append({
                "name": f"{name}[{dtn}]", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/" + (
                    "flash_attention_wg.cu" if hopper
                    else "flash_attention.cu"),
                "replaces": rep, "launches": launches[name],
                "max_abs_err": f["max_abs_err"][kk], "ms": f["ms"][kk],
                "plain_ms": f["plain_ms"][kk],
                "bound_ms": f["bound_ms"][kk],
                "bound_by": f["bound_by"][kk],
                "library_ms": f["library_ms"][kk],
                "share_of_bound": f["bound_share"][kk],
                "sdpa_ratio": f["sdpa_ratio"] and f["sdpa_ratio"][
                    "fwd" if kk == "fwd" else "bwd"]})
            if key == "f32_dit_xl2":
                kernel_rows[-1]["launches_from"] = \
                    "tiny-dit-parity d 72 float32 (timed at b 32 x s 256)"
    # head_dim 64 with 16 / 8 heads, b 4 x s 2048, causal: train-moe's three
    # rows at hidden 1024, their launches summed
    f = heads["moe_d64"]
    d64_rows = ("moe_dense", "moe_ragged", "moe_ragged_e64")
    for kk, name, rep in (
            ("fwd", "flash_fwd", tpu + "flash_attention.py:69"),
            ("dq", "flash_bwd_dq", tpu + "flash_attention.py:174"),
            ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:229")):
        kernel_rows.append({
            "name": f"{name}[d 64, 16/8 heads, train-moe]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_wg.cu",
            "replaces": rep,
            "launches": sum(moe_launches[t][name] for t in d64_rows),
            "launches_by_phase": {t: moe_launches[t][name]
                                  for t in d64_rows},
            "max_abs_err": f["max_abs_err"][kk], "ms": f["ms"][kk],
            "plain_ms": f["plain_ms"][kk], "bound_ms": f["bound_ms"][kk],
            "bound_by": f["bound_by"][kk],
            "library_ms": f["library_ms"][kk],
            "share_of_bound": f["bound_share"][kk],
            "sdpa_ratio": f["sdpa_ratio"] and f["sdpa_ratio"][
                "fwd" if kk == "fwd" else "bwd"]})
    # head_dim 128 at b 2 x s 4096, causal: train-moe-full's DeepSeek (16 /
    # 16 heads) and Qwen (28 / 4, group 7) rows
    for key, name, heads_name in (
            ("deepseek_moe_16b", "deepseek", "16/16 heads"),
            ("qwen2_moe_a14b", "qwen", "28/4 heads, group 7")):
        f = heads[key]
        for kk, kname, rep in (
                ("fwd", "flash_fwd", tpu + "flash_attention.py:69"),
                ("dq", "flash_bwd_dq", tpu + "flash_attention.py:174"),
                ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:229")):
            kernel_rows.append({
                "name": f"{kname}[d 128, {heads_name}, s 4096, "
                        f"train-moe-full]", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention_wg.cu",
                "replaces": rep, "launches": full_launches[name][kname],
                "max_abs_err": f["max_abs_err"][kk], "ms": f["ms"][kk],
                "plain_ms": f["plain_ms"][kk],
                "bound_ms": f["bound_ms"][kk],
                "bound_by": f["bound_by"][kk],
                "library_ms": f["library_ms"][kk],
                "share_of_bound": f["bound_share"][kk],
                "sdpa_ratio": f["sdpa_ratio"] and f["sdpa_ratio"][
                    "fwd" if kk == "fwd" else "bwd"]})
    # head_dim 128 at b 1 x s 4096, 8 / 2 heads (group 4), causal: one
    # mp-4 rank of train-tp-8b
    f = heads["tp4_8b"]
    for kk, kname, rep in (
            ("fwd", "flash_fwd", tpu + "flash_attention.py:157"),
            ("dq", "flash_bwd_dq", tpu + "flash_attention.py:326"),
            ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:358")):
        kernel_rows.append({
            "name": f"{kname}[d 128, 8/2 heads, s 4096, an mp-4 rank, "
                    f"train-tp-8b]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_wg.cu",
            "replaces": rep, "launches": tp_train_launches[kname],
            "max_abs_err": f["max_abs_err"][kk], "ms": f["ms"][kk],
            "plain_ms": f["plain_ms"][kk], "bound_ms": f["bound_ms"][kk],
            "bound_by": f["bound_by"][kk],
            "library_ms": f["library_ms"][kk],
            "share_of_bound": f["bound_share"][kk],
            "tflops": f["tflops"][kk],
            "sdpa_ratio": f["sdpa_ratio"] and f["sdpa_ratio"][
                "fwd" if kk == "fwd" else "bwd"]})
    _emit({"kernels": kernel_rows})
    print(smi, flush=True)
    _emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
