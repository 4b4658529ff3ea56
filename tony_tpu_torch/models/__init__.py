"""The decoder transformer (``transformer``, with MoE blocks), the ResNet
family (``resnet``), KV-cache generation and beam search (``generate``),
int8 weight-only conversion (``quantize``), and weight import from the
JAX package (``convert``) and from HF checkpoints (``hf``: GPT-2,
Llama, Mistral, Qwen2, Gemma, Mixtral, GPT-NeoX, Phi)."""

from tony_tpu_torch.models.generate import (beam_search, generate,
                                            init_cache, multi_decode_step,
                                            single_decode_step)
from tony_tpu_torch.models.hf import (convert_gpt2_state_dict,
                                      convert_llama_state_dict,
                                      convert_mixtral_state_dict,
                                      convert_neox_state_dict,
                                      convert_phi_state_dict, gemma_config,
                                      gpt2_config, llama_config,
                                      load_hf_dir, mixtral_config,
                                      neox_config, phi_config)
from tony_tpu_torch.models.quantize import quantize_for_serving
from tony_tpu_torch.models.resnet import (BottleneckResNetBlock, ResNet,
                                          ResNet18, ResNet34, ResNet50,
                                          ResNet101, ResNet152, ResNetBlock)
from tony_tpu_torch.models.transformer import (RopeScaling, Transformer,
                                               TransformerConfig,
                                               moe_aux_loss)

__all__ = ["BottleneckResNetBlock", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "ResNet152", "ResNetBlock",
           "RopeScaling", "Transformer", "TransformerConfig", "beam_search",
           "convert_gpt2_state_dict", "convert_llama_state_dict",
           "convert_mixtral_state_dict", "convert_neox_state_dict",
           "convert_phi_state_dict", "gemma_config", "generate",
           "gpt2_config", "init_cache", "llama_config", "load_hf_dir",
           "mixtral_config", "moe_aux_loss", "multi_decode_step",
           "neox_config", "phi_config", "quantize_for_serving",
           "single_decode_step"]
