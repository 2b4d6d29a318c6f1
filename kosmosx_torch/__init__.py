"""kosmosx_torch: the PyTorch and CUDA port of kosmosx_tpu for an NVIDIA H100.

The module layout mirrors the JAX package (``core``, ``nn``, ``ops``,
``models``, ``data``, ``generate``, ``train``, ``utils``) so that every
counterpart is easy to find. Plain tensor code is PyTorch; the Pallas
kernels on the serving, training and weight-only int8 paths (flash attention
forward and backward, decode attention, the W8 matmuls) are hand-written CUDA
for ``sm_90a``
(``csrc/``), built at first use. This package never imports jax, optax or
kosmosx_tpu.
"""

__version__ = "0.1.0"

from kosmosx_torch.core.config import (AudioConfig, KosmosConfig,
                                       MagnetoConfig, ResamplerConfig,
                                       VideoConfig, VisionConfig,
                                       Wav2Vec2Config)
from kosmosx_torch.generate.beam import beam_search, beam_search_multimodal
from kosmosx_torch.generate.sampler import (SamplingConfig, generate_multimodal,
                                            generate_text)
from kosmosx_torch.generate.speculative import speculative_generate
from kosmosx_torch.models.any_modality import KosmosAny
from kosmosx_torch.models.conditional import KosmosConditional
from kosmosx_torch.models.kosmos import Kosmos
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.ops.decode_attention import decode_attention
from kosmosx_torch.ops.flash_attention import flash_attention
from kosmosx_torch.ops.quant_matmul import w8_matmul, w8_matmul_stacked
from kosmosx_torch.utils.quantize import quantize_params_w8, w8_param_bytes

__all__ = [
    "Kosmos",
    "KosmosLanguage",
    "KosmosConditional",
    "KosmosAny",
    "KosmosConfig",
    "MagnetoConfig",
    "ResamplerConfig",
    "VisionConfig",
    "AudioConfig",
    "VideoConfig",
    "Wav2Vec2Config",
    "SamplingConfig",
    "generate_text",
    "generate_multimodal",
    "beam_search",
    "beam_search_multimodal",
    "speculative_generate",
    "flash_attention",
    "decode_attention",
    "w8_matmul",
    "w8_matmul_stacked",
    "quantize_params_w8",
    "w8_param_bytes",
]
