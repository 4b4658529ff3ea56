"""The decoder transformer (``transformer``, with MoE blocks), the ResNet
family (``resnet``), KV-cache generation and beam search (``generate``),
int8 weight-only conversion (``quantize``), and weight import from the
JAX package (``convert``) and from HF checkpoints (``hf``: Llama,
Mistral, Qwen2, Mixtral)."""

from tony_tpu_torch.models.generate import (beam_search, generate,
                                            init_cache, multi_decode_step,
                                            single_decode_step)
from tony_tpu_torch.models.hf import (convert_mixtral_state_dict,
                                      load_hf_dir, mixtral_config)
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
           "convert_mixtral_state_dict", "generate", "init_cache",
           "load_hf_dir", "mixtral_config", "moe_aux_loss",
           "multi_decode_step", "quantize_for_serving",
           "single_decode_step"]
