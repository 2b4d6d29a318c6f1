"""Kosmos: CLIP ViT-L/14 + PerceiverResampler + Magneto decoder
(counterpart of kosmosx_tpu/models/kosmos.py).

``Kosmos.apply(text_tokens, images)`` -> logits (B, L + M*64, vocab):
vision tower, resampler to 64 latents, projection to decoder width, scaled
text embedding, image block spliced in after [BOS, <image>], positions added
(with the reference's double embed-scale when ``parity_double_scale``), the
decoder stack and the output projection.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import KosmosConfig
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.data.splice import splice_embeddings, spliced_segment_ids
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.resampler import init_resampler, resampler
from kosmosx_torch.nn.vision import clip_vit, init_clip_vit
from kosmosx_torch.utils import trace


class Kosmos(ParamTree):
    """Multimodal decoder LM. Its parameters are named by their JAX tree
    paths (``clip.layers.0.mlp.fc1.b``, ``decoder.layers.3.attn.q.A.w``).

    Build it from a seeded ``torch.Generator`` (random init on ``device``,
    the card unless ``device="cpu"`` is asked for; the generator must lie on
    that device) or from a parameter tree, e.g.
    ``utils.jax_params.from_jax_params``."""

    def __init__(self, config: Optional[KosmosConfig] = None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 params: Optional[Dict[str, Any]] = None):
        config = config or KosmosConfig()
        if params is None:
            if generator is None:
                raise ValueError("pass a seeded torch.Generator or params")
            params = Kosmos.init(generator, config, device=device)
        super().__init__(params)
        self.config = config

    @staticmethod
    def init(gen: torch.Generator, cfg: KosmosConfig,
             device=None) -> Dict[str, Any]:
        """kosmosx_tpu/models/kosmos.py:54-65, on ``device`` (None: the
        card)."""
        device = init.model_device(gen, device)
        return {
            "clip": init_clip_vit(gen, cfg.vision, device),
            "resampler": init_resampler(gen, cfg.resampler, device),
            "image_proj": {"w": init.magneto_output_projection(
                gen, (cfg.resampler.dim, cfg.decoder.embed_dim), device)},
            "decoder": dec.init_decoder(gen, cfg.decoder, device=device),
        }

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) or (B, M, 3, H, W) CLIP-normalised pixels ->
        (B, [M,] image_embed_len, decoder_dim)
        (kosmosx_tpu/models/kosmos.py:67-83)."""
        cfg = self.config
        multi = images.ndim == 5
        if multi:
            b, m = images.shape[:2]
            images = images.reshape((b * m,) + tuple(images.shape[2:]))
        with trace.span("model.vision", device=True, images=images.shape[0]):
            feats = clip_vit(self["clip"], images, cfg.vision)
            lat = resampler(self["resampler"], feats, cfg.resampler)[:, 0]
            img = layers.linear(self["image_proj"], lat, dtype=cfg.dtype)
        if multi:
            img = img.reshape(b, m, cfg.image_embed_len, -1)
        return img

    def embed_prompt(self, text_tokens: torch.Tensor, images: torch.Tensor,
                     image_positions: Optional[torch.Tensor] = None):
        """Decoder input for an image+text prompt: (x, num_images)
        (kosmosx_tpu/models/kosmos.py:102-120, the steps generation shares)."""
        cfg, dcfg = self.config, self.config.decoder
        img = self.encode_images(images)
        num_images = img.shape[1] if img.ndim == 4 else 1
        text_emb = dec.embed_only(self["decoder"], dcfg, text_tokens)
        spliced = splice_embeddings(text_emb, img, image_positions,
                                    index=cfg.splice_index)
        if cfg.parity_double_scale:
            x, _ = dec.forward_embedding(self["decoder"], dcfg,
                                         token_embedding=spliced)
        else:
            x = spliced + layers.positional_embedding(
                self["decoder"]["pos"], spliced.shape[1],
                padding_idx=dcfg.padding_idx, dtype=dcfg.dtype)
        return x, num_images

    def apply(self, text_tokens: torch.Tensor, images: torch.Tensor, *,
              image_positions: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None,
              use_padding_mask: bool = False,
              rng: Optional[int] = None, with_aux: bool = False):
        """Forward pass -> logits (B, L + M*64, vocab), or (logits, aux)
        with ``with_aux``, aux the summed MoE routing loss (0 for a dense
        decoder) (kosmosx_tpu/models/kosmos.py:86-135). ``use_padding_mask``
        derives segment ids from the padding tokens. The dropout key ``rng``
        is split as JAX splits it, one key for the spliced input, one for
        the decoder layers."""
        dcfg = self.config.decoder
        x, num_images = self.embed_prompt(text_tokens, images, image_positions)
        x = layers.dropout(x, dcfg.dropout, layers.fold_in(rng, 0))
        if segment_ids is None and use_padding_mask:
            segment_ids = spliced_segment_ids(
                text_tokens, dcfg.padding_idx, num_images,
                self.config.image_embed_len, image_positions,
                index=self.config.splice_index)
        with trace.span("model.decoder", device=True) as sp:
            if sp.on:
                sp.set(shape=list(x.shape[:2]))
            out = dec.run_layers(self["decoder"], x, dcfg,
                                 segment_ids=segment_ids,
                                 rng=layers.fold_in(rng, 1), with_aux=with_aux)
        with trace.span("model.head", device=True):
            if with_aux:
                return dec.output_logits(self["decoder"], out[0], dcfg), \
                    out[1]
            return dec.output_logits(self["decoder"], out, dcfg)

    forward = apply
