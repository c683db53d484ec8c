from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    llama_1b, llama_3_8b, llama_mid, llama_small, llama_tiny)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_tiny",
           "llama_small", "llama_mid", "llama_1b", "llama_3_8b"]
