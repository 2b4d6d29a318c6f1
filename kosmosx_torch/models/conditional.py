"""KosmosConditional: a multimodal decoder built with only the towers asked
for (counterpart of kosmosx_tpu/models/conditional.py).

Modalities: text (always), image (CLIP ViT, resampler, projection), audio
(``nn/audio.py``, mean-pooled over frames), video (``nn/video.py``). Each
provided modality adds a block of embeddings, spliced after BOS in (image,
audio, video) order, not at Kosmos's index 2:

    [BOS, 64 image | 1 audio | 1 video embeddings..., text[1:]...]

Padding tokens of the text get segment id -1, everything else 0.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import (AudioConfig, MagnetoConfig,
                                       ResamplerConfig, VideoConfig,
                                       VisionConfig)
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.audio import audio_encoder, init_audio_encoder
from kosmosx_torch.nn.resampler import init_resampler, resampler
from kosmosx_torch.nn.video import init_video_encoder, video_encoder
from kosmosx_torch.nn.vision import clip_vit, init_clip_vit

MODALITIES = ("text", "image", "audio", "video")


class KosmosConditional(ParamTree):
    """Build-what-you-need multimodal decoder. Parameters are named by
    their JAX tree paths (``audio_enc.layers.3.attn.q.w``,
    ``video_enc.stages.1.0.down.w``).

    Build it from a seeded ``torch.Generator`` (random init on ``device``,
    the card unless ``device="cpu"`` is asked for) or from a parameter tree
    holding the decoder and the requested towers, e.g.
    ``utils.jax_params.from_jax_params`` of a JAX model's ``params``. The
    module is the tree (JAX's ``model.params``); the configs are
    ``decoder_config``, ``vision_config``, ``resampler_config``,
    ``audio_config`` and ``video_config``, since ``decoder`` and
    ``resampler`` name subtrees."""

    def __init__(self, modalities: Sequence[str] = ("text", "image"),
                 decoder: Optional[MagnetoConfig] = None,
                 vision: Optional[VisionConfig] = None,
                 resampler: Optional[ResamplerConfig] = None,
                 audio: Optional[AudioConfig] = None,
                 video: Optional[VideoConfig] = None,
                 image_embed_len: int = 64, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 params: Optional[Dict[str, Any]] = None):
        unknown = set(modalities) - set(MODALITIES)
        if unknown:
            raise ValueError(f"unknown modalities: {unknown}")
        modalities = tuple(m for m in MODALITIES
                           if m in set(modalities) | {"text"})
        decoder = decoder or MagnetoConfig()
        vision = vision or VisionConfig()
        resampler = resampler or ResamplerConfig()
        audio = audio or AudioConfig()
        video = video or VideoConfig()
        if params is None:
            if generator is None:
                raise ValueError("pass a seeded torch.Generator or params")
            params = self._init(generator, modalities, decoder, vision,
                                resampler, audio, video,
                                init.model_device(generator, device))
        super().__init__(params)
        self.modalities = modalities
        self.decoder_config = decoder
        self.vision_config = vision
        self.resampler_config = resampler
        self.audio_config = audio
        self.video_config = video
        self.image_embed_len = image_embed_len

    @staticmethod
    def _init(gen, modalities, dcfg, vcfg, rcfg, acfg, vidcfg,
              device) -> Dict[str, Any]:
        """kosmosx_tpu/models/conditional.py:74-93."""
        d = dcfg.embed_dim
        params: Dict[str, Any] = {
            "decoder": dec.init_decoder(gen, dcfg, device=device)}
        if "image" in modalities:
            params["clip"] = init_clip_vit(gen, vcfg, device)
            params["resampler"] = init_resampler(gen, rcfg, device)
            params["image_proj"] = {"w": init.magneto_output_projection(
                gen, (rcfg.dim, d), device)}
        if "audio" in modalities:
            params["audio_enc"] = init_audio_encoder(gen, acfg, device)
            params["audio_proj"] = {"w": init.magneto_output_projection(
                gen, (acfg.hidden_dim, d), device)}
        if "video" in modalities:
            params["video_enc"] = init_video_encoder(gen, vidcfg, device)
            params["video_proj"] = {"w": init.magneto_output_projection(
                gen, (vidcfg.hidden_dim, d), device)}
        return params

    def media_blocks(self, *, images=None, audios=None, videos=None) -> list:
        """The embedding block of each provided modality, in (image, audio,
        video) order: (B, image_embed_len | 1 | 1, decoder dim)
        (kosmosx_tpu/models/conditional.py:97-114)."""
        dtype = self.decoder_config.dtype
        blocks = []
        if images is not None:
            assert "image" in self.modalities, "model built without image tower"
            feats = clip_vit(self["clip"], images, self.vision_config)
            lat = resampler(self["resampler"], feats,
                            self.resampler_config)[:, 0]
            blocks.append(layers.linear(self["image_proj"], lat, dtype=dtype))
        if audios is not None:
            assert "audio" in self.modalities, "model built without audio tower"
            a = audio_encoder(self["audio_enc"], audios, self.audio_config)
            a = a.mean(dim=1, keepdim=True)
            blocks.append(layers.linear(self["audio_proj"], a, dtype=dtype))
        if videos is not None:
            assert "video" in self.modalities, "model built without video tower"
            v = video_encoder(self["video_enc"], videos, self.video_config)
            blocks.append(layers.linear(self["video_proj"], v[:, None],
                                        dtype=dtype))
        return blocks

    def apply(self, text_tokens: torch.Tensor, *, images=None, audios=None,
              videos=None, rng: Optional[int] = None,
              use_padding_mask: bool = True) -> torch.Tensor:
        """Forward pass -> logits (B, L + media, vocab)
        (kosmosx_tpu/models/conditional.py:96-143). The dropout key ``rng``
        splits into the spliced input's key and the decoder layers'."""
        dcfg = self.decoder_config
        blocks = self.media_blocks(images=images, audios=audios, videos=videos)
        text_emb = dec.embed_only(self["decoder"], dcfg, text_tokens)
        k = 0
        spliced = text_emb
        if blocks:
            media = torch.cat(blocks, dim=1).to(text_emb.dtype)
            k = media.shape[1]
            spliced = torch.cat([text_emb[:, :1], media, text_emb[:, 1:]],
                                dim=1)
        x, _ = dec.forward_embedding(self["decoder"], dcfg,
                                     token_embedding=spliced,
                                     rng=layers.fold_in(rng, 0))
        segment_ids = None
        if use_padding_mask:
            valid = text_tokens != dcfg.padding_idx
            b = text_tokens.shape[0]
            valid = torch.cat([valid[:, :1], valid.new_ones((b, k)),
                               valid[:, 1:]], dim=1)
            segment_ids = torch.where(valid, 0, -1).to(torch.int32)
        h = dec.run_layers(self["decoder"], x, dcfg, segment_ids=segment_ids,
                           rng=layers.fold_in(rng, 1))
        return dec.output_logits(self["decoder"], h, dcfg)

    forward = apply

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
