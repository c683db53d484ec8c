"""A module-level engine factory of ``test_torch_transport.py``'s GPT
process fleet (JAX ``test_transport_fleet.py``'s ``_gpt_engine``): a
spawned worker imports it by name and builds the seeded GPT model, its
``PagedGPTDecoder`` and the engine inside the worker, so every replica
holds the same weights."""

GPT_GEOM = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)


def gpt_engine(idx, devices):
    from paddle_tpu_torch.inference import PagedGPTDecoder, ServingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(**GPT_GEOM), seed=0, device="cpu")
    dec = PagedGPTDecoder.from_model(model, num_blocks=24, block_size=8,
                                     device="cpu")
    return ServingEngine(dec, max_batch_size=3, prompt_buckets=(8, 16, 32),
                         chunk_size=4, prefill_chunk=8)
