"""The decoder transformer (``transformer``), the ResNet family
(``resnet``), KV-cache generation and beam search (``generate``), int8
weight-only conversion (``quantize``), and weight import from the JAX
package (``convert``) and from HF checkpoints (``hf``)."""

from tony_tpu_torch.models.generate import (beam_search, generate,
                                            init_cache, multi_decode_step,
                                            single_decode_step)
from tony_tpu_torch.models.quantize import quantize_for_serving
from tony_tpu_torch.models.resnet import (BottleneckResNetBlock, ResNet,
                                          ResNet18, ResNet34, ResNet50,
                                          ResNet101, ResNet152, ResNetBlock)
from tony_tpu_torch.models.transformer import (RopeScaling, Transformer,
                                               TransformerConfig)

__all__ = ["BottleneckResNetBlock", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "ResNet152", "ResNetBlock",
           "RopeScaling", "Transformer", "TransformerConfig", "beam_search",
           "generate", "init_cache", "multi_decode_step",
           "quantize_for_serving", "single_decode_step"]
