from .bert import BertConfig, BertForPretraining, BertModel
from .ernie_moe import (ErnieMoEConfig, ErnieMoEForCausalLM,
                        ernie_moe_flops_per_token)
from .llama import LlamaConfig, LlamaForCausalLM, llama_flops_per_token

__all__ = ["BertConfig", "BertForPretraining", "BertModel",
           "ErnieMoEConfig", "ErnieMoEForCausalLM", "ernie_moe_flops_per_token",
           "LlamaConfig", "LlamaForCausalLM", "llama_flops_per_token"]
