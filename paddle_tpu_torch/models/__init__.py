from .dit import DiT, DiTConfig, dit_s_2, dit_tiny, dit_xl_2  # noqa: F401
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  ernie_45_dense_3b, gpt_345m, gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    llama_1b, llama_3_8b, llama_mid, llama_small, llama_tiny)
from .moe_lm import (MoEConfig, MoEForCausalLM, MoEModel,  # noqa: F401
                     deepseek_moe_16b_like, moe_tiny, qwen2_moe_a14b_like)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_tiny",
           "llama_small", "llama_mid", "llama_1b", "llama_3_8b",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_tiny",
           "gpt_345m", "ernie_45_dense_3b", "DiTConfig", "DiT", "dit_tiny",
           "dit_s_2", "dit_xl_2", "MoEConfig", "MoEForCausalLM", "MoEModel",
           "moe_tiny", "deepseek_moe_16b_like", "qwen2_moe_a14b_like"]
