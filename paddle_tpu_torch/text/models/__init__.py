from .bert import BertConfig, BertForPretraining, BertModel
from .ernie_moe import (ErnieMoEConfig, ErnieMoEForCausalLM,
                        ernie_moe_flops_per_token)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel, build_llama_pipe, force_tp_layers,
                    llama_flops_per_token)

__all__ = ["BertConfig", "BertForPretraining", "BertModel",
           "ErnieMoEConfig", "ErnieMoEForCausalLM", "ernie_moe_flops_per_token",
           "LlamaConfig", "LlamaDecoderLayer", "LlamaForCausalLM",
           "LlamaModel", "build_llama_pipe", "force_tp_layers",
           "llama_flops_per_token"]
