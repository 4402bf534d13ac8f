from .llama import LlamaConfig, LlamaForCausalLM, llama_flops_per_token

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_flops_per_token"]
