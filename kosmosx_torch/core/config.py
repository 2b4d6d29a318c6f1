"""Configuration dataclasses, mirrored from ``kosmosx_tpu/core/config.py``.

Same fields, same defaults, same derived properties as the JAX package
(``MagnetoConfig`` at kosmosx_tpu/core/config.py:37, ``VisionConfig`` :180,
``ResamplerConfig`` :217, ``KosmosConfig`` :241, ``Wav2Vec2Config`` :265,
``AudioConfig`` :302, ``VideoConfig`` :327), so a config built for one
package describes the same model in the other. The only difference is that
``dtype`` resolves the dtype name to a torch dtype.

Some fields describe features that this package has not ported yet; the code
that would read them raises ``NotImplementedError`` instead of ignoring them
(see ``check_supported``). ``flash_block_q``/``flash_block_kv`` are TPU tile
sizes kept for the mirror: the CUDA flash kernel picks its own tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


# remat policies (kosmosx_tpu/nn/decoder.py:337-344)
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class MagnetoConfig:
    """Magneto (sub-LN) decoder configuration (kosmosx_tpu/core/config.py:37).

    Field comments are in the JAX counterpart; defaults are the flagship
    24L / 2048d / 8192ffn / 32h decoder with vocab 32002.

    ``decode_attn_kernel`` keeps the JAX default (off), under which a decode
    step runs plain attention over the cache. Serving on a GPU should set it:
    then every decode step runs the hand-written decode kernel
    (``kosmosx_torch/csrc/decode_attention.cu``)."""

    vocab_size: int = 32002
    embed_dim: int = 2048
    ffn_dim: int = 8192
    layers: int = 24
    heads: int = 32
    max_positions: int = 2048
    padding_idx: int = 1
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    activation: str = "gelu"
    subln: bool = True
    multiway: bool = True
    xpos_rel_pos: bool = True
    xpos_scale_base: int = 512
    scale_embedding: bool = True
    compute_dtype: str = "float32"
    activation_fp32: bool = True
    use_flash_attention: bool = True
    flash_block_q: int = 1024
    flash_block_kv: int = 1024
    remat: bool = False
    remat_policy: str = "nothing"
    scan_layers: bool = False
    sequence_axis: Optional[str] = None
    sequence_schedule: str = "ring"
    kv_cache_dtype: Optional[str] = None
    kv_window: int = 0
    kv_sink: int = 4
    decode_unroll: bool = True
    decode_unroll_min_len: int = 0
    decode_attn_kernel: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 1e-3

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @property
    def embed_scale(self) -> float:
        return float(self.embed_dim) ** 0.5 if self.scale_embedding else 1.0

    @property
    def max_target_positions(self) -> int:
        """Longest sequence the learned positional table can index
        (kosmosx_tpu/core/config.py:171)."""
        return self.max_positions - self.padding_idx - 1

    def check_supported(self) -> None:
        """Raise for the fields whose features this package does not run.

        ``decode_unroll*`` are XLA execution choices with no meaning here
        (the layer stack is always a Python loop over per-layer modules), so
        they are accepted and have no effect. ``scan_layers`` only picks the
        layout ``utils/quantize.quantize_params_w8`` gives the decoder's W8
        weights: stacked codes shared by the layers, which the W8 stacked
        kernel indexes.
        ``remat`` checkpoints each decoder layer when gradients are taken
        (``nn/decoder.py::run_layers``), with the ``remat_policy``
        ``"nothing"``, ``"dots"`` or ``"dots_no_batch"``. ``moe_experts >
        0`` replaces every layer's FFN with the MoE FFN (``nn/moe.py``).
        ``sequence_axis`` names the mesh dim whose process group
        ``parallel.seq_parallel``'s step passes down to the attention
        (``sequence_group``), and ``sequence_schedule`` is its ring's
        layout, ``"ring"`` or ``"zigzag"``."""
        if self.sequence_schedule not in ("ring", "zigzag"):
            raise ValueError(f"unknown sequence_schedule "
                             f"{self.sequence_schedule!r}; choose ring or "
                             f"zigzag")
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"choose from {sorted(REMAT_POLICIES)}")


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT tower; defaults are ViT-L/14 (kosmosx_tpu/core/config.py:180)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_dim: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"
    compute_dtype: str = "float32"
    use_flash_attention: bool = True
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.heads

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Flamingo PerceiverResampler (kosmosx_tpu/core/config.py:217)."""

    dim: int = 1024
    depth: int = 2
    dim_head: int = 64
    heads: int = 8
    num_latents: int = 64
    num_media_embeds: int = 257
    ff_mult: int = 4
    compute_dtype: str = "float32"

    @property
    def inner_dim(self) -> int:
        return self.dim_head * self.heads

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class KosmosConfig:
    """Full multimodal composition (kosmosx_tpu/core/config.py:241)."""

    decoder: MagnetoConfig = MagnetoConfig()
    vision: VisionConfig = VisionConfig()
    resampler: ResamplerConfig = ResamplerConfig()
    image_embed_len: int = 64
    splice_index: int = 2
    parity_double_scale: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.dtype


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The HF wav2vec2 / data2vec-audio encoder (kosmosx_tpu/core/config.py:
    265); defaults are wav2vec2-base. ``feat_norm`` "group" normalises conv
    0 per channel over time, "layer" every conv over channels;
    ``pos_conv_mode`` "wav2vec2" is one grouped conv, "data2vec"
    ``pos_convs`` stacked ones; ``stable_layer_norm`` picks pre-LN layers."""

    hidden_dim: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_norm: str = "group"
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    pos_conv_mode: str = "wav2vec2"
    pos_convs: int = 5
    stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio tower (kosmosx_tpu/core/config.py:302): ``arch="framed"`` the
    framed-matmul encoder, ``"wav2vec2"`` the HF encoder of shape ``w2v``."""

    hidden_dim: int = 768
    layers: int = 4
    heads: int = 12
    mlp_dim: int = 3072
    conv_widths: Tuple[int, ...] = (512, 512, 512)
    arch: str = "framed"
    w2v: Wav2Vec2Config = Wav2Vec2Config()
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Video tower (kosmosx_tpu/core/config.py:327): ``arch="lean"`` the
    LayerNorm ResNet, ``"r3d18"`` torchvision's r3d_18 topology with its
    BatchNorms folded (``hidden_dim`` 512)."""

    hidden_dim: int = 512
    frame_size: int = 112
    arch: str = "lean"
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)


# the layer pattern of LFM2-24B-A2B: conv, conv, attn, then (conv, conv,
# conv, attn) nine times, then conv
LFM2_LAYER_TYPES = (("conv", "conv", "full_attention")
                    + ("conv", "conv", "conv", "full_attention") * 9
                    + ("conv",))


@dataclasses.dataclass(frozen=True)
class Lfm2Config:
    """The ``lfm2_moe`` hybrid decoder (LiquidAI's LFM2 MoE family; the
    defaults are LFM2-24B-A2B's published ``config.json``, whose key names
    the fields keep).

    A layer is ``h = x + mixer(operator_norm(x))``, ``out = h +
    ffn(ffn_norm(h))``. ``layer_types[i]`` picks the mixer: ``"conv"``, the
    gated short convolution (``in_proj`` to B, C and x~, ``C * conv(B *
    x~)`` with a causal depthwise kernel of 3 taps and no bias,
    ``out_proj``), or ``"full_attention"``, GQA over heads of 64 with
    per-head RMSNorm on q and k and RoPE. The first ``num_dense_layers``
    layers have a SwiGLU FFN of ``intermediate_size``, the rest
    ``num_experts`` SwiGLU experts of ``moe_intermediate_size`` behind a
    sigmoid router whose top ``num_experts_per_tok`` are chosen with an
    expert bias added, gates normalised over the chosen ones, no capacity
    and no dropped tokens. Every norm is RMSNorm with ``norm_eps``; the
    head is the embedding. The published keys this package takes at one
    value only (``conv_L_cache`` 3, ``conv_bias`` false, ``norm_topk_prob``
    and ``use_expert_bias`` true, a tied head) are not fields. This
    package runs its forward pass (``models/lfm2.Lfm2``)."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 11776
    moe_intermediate_size: int = 1536
    layer_types: Tuple[str, ...] = LFM2_LAYER_TYPES
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    num_dense_layers: int = 2
    num_experts: int = 64
    num_experts_per_tok: int = 4
    routed_scaling_factor: float = 1.0
    compute_dtype: str = "bfloat16"

    @property
    def num_hidden_layers(self) -> int:
        return len(self.layer_types)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    def check_supported(self) -> None:
        """Raise for settings this package does not run: a layer type
        other than the two, heads of another size than 64 (the flash and
        QK-norm kernels'), or query heads that do not share the key/value
        heads evenly."""
        unknown = set(self.layer_types) - {"conv", "full_attention"}
        if unknown:
            raise ValueError(f"unknown layer types {sorted(unknown)}")
        if self.head_dim * self.num_attention_heads != self.hidden_size \
                or self.head_dim != 64:
            raise ValueError(f"heads of 64 only: {self.num_attention_heads} "
                             f"heads over {self.hidden_size}")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(f"{self.num_attention_heads} query heads do not "
                             f"share {self.num_key_value_heads} key/value "
                             f"heads evenly")
