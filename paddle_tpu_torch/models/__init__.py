from .llama import LlamaConfig, llama_3_8b, llama_tiny  # noqa: F401

__all__ = ["LlamaConfig", "llama_tiny", "llama_3_8b"]
