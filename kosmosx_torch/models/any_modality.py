"""Any-modality pipeline: a detector, a processor registry and encoders
registered per modality (counterpart of kosmosx_tpu/models/any_modality.py).

``ModalityDetector`` reads a modality from a user override, a file
extension or an input's shape; ``ModalityProcessor`` preprocesses each
modality (images through ``data/images.preprocess_images``) onto a device;
``KosmosAny`` builds an encoder and its projection to the decoder width
when a modality is registered, and splices every registered modality's
embeddings after BOS.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import (AudioConfig, MagnetoConfig,
                                       ResamplerConfig, VideoConfig,
                                       VisionConfig)
from kosmosx_torch.core.params import ParamTree, _node, tree_device
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers

IMAGE_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp"}
AUDIO_EXT = {".wav", ".flac", ".mp3", ".ogg"}
VIDEO_EXT = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


class ModalityDetector:
    """A sample's modality from a user override, a path's extension or an
    array's shape (kosmosx_tpu/models/any_modality.py:37-66)."""

    def detect(self, data: Any, *, path: Optional[str] = None,
               user_modality: Optional[str] = None) -> str:
        if user_modality:
            return user_modality
        if path:
            ext = os.path.splitext(path)[1].lower()
            if ext in IMAGE_EXT:
                return "image"
            if ext in AUDIO_EXT:
                return "audio"
            if ext in VIDEO_EXT:
                return "video"
            if ext in {".txt", ".md", ".json"}:
                return "text"
        if isinstance(data, str):
            return "text"
        arr = data if hasattr(data, "ndim") else np.asarray(data)
        if arr.ndim == 5:  # (B, 3, T, H, W)
            return "video"
        if arr.ndim == 4 and arr.shape[1] == 3:
            return "image"
        if arr.ndim <= 2:
            return "audio"  # raw waveform (T,) or (B, T)
        return "any"


class ModalityProcessor:
    """Per-modality preprocessing onto ``device``, with user-registered
    processors first (kosmosx_tpu/models/any_modality.py:69-87)."""

    def __init__(self, device=None):
        self.device = device
        self._cache: Dict[str, Callable] = {}

    def register(self, modality: str, fn: Callable) -> None:
        self._cache[modality] = fn

    def process(self, modality: str, data: Any, *, image_size: int = 224):
        if modality in self._cache:
            return self._cache[modality](data)
        if modality == "image":
            from kosmosx_torch.data.images import preprocess_images
            return preprocess_images(torch.as_tensor(data, device=self.device),
                                     image_size=image_size)
        if modality in ("audio", "video", "any"):
            return torch.as_tensor(data, dtype=torch.float32,
                                   device=self.device)
        raise ValueError(f"no processor for modality {modality!r}")


class KosmosAny(ParamTree):
    """Any-modality Kosmos: each modality's encoder and its projection to the
    decoder width are made when the modality is registered
    (``register_modality``), so ``apply`` never adds a parameter; every
    modality's embeddings splice after BOS.

    ``unified=True`` sends every non-text modality through one shared trunk
    (``nn/unified.py``) instead of per-modality towers.

    The module is the parameter tree (JAX's ``model.params``); registration
    adds subtrees to it, drawn from ``generator``, a seeded
    ``torch.Generator`` on the model's device (the card unless
    ``device="cpu"``). Register every modality before building an
    optimizer: one built earlier never sees the later leaves.

    A carried tree: pass ``params`` (e.g. ``utils.jax_params.
    from_jax_params`` of a JAX ``KosmosAny``'s ``params``), the decoder and
    every tower it holds, then register the same modalities, in the same
    order, as the JAX model did. Registration takes a tower's leaves from
    the tree where it holds them and draws new ones only where it does
    not, so the carried model runs JAX's weights."""

    SPECIAL_TAGS = ("<image>", "</image>", "<audio>", "</audio>",
                    "<video>", "</video>", "<any>", "</any>")

    def __init__(self, decoder: Optional[MagnetoConfig] = None,
                 image_embed_len: int = 64, unified: bool = False,
                 unified_config=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 params: Optional[Dict[str, Any]] = None):
        decoder = decoder or MagnetoConfig()
        if params is None:
            if generator is None:
                raise ValueError("pass a seeded torch.Generator or params")
            params = {"decoder": dec.init_decoder(
                generator, decoder,
                device=init.model_device(generator, device))}
        super().__init__(params)
        self.decoder_config = decoder
        self.image_embed_len = image_embed_len
        self.unified = unified
        self._gen = generator
        self.detector = ModalityDetector()
        self.processor = ModalityProcessor(self.device)
        self._encoders: Dict[str, Callable] = {}
        self.configs = {
            "image": (VisionConfig(), ResamplerConfig()),
            "audio": AudioConfig(),
            "video": VideoConfig(),
        }
        if unified:
            from kosmosx_torch.nn.unified import UnifiedConfig
            self.unified_config = unified_config or UnifiedConfig()

    @property
    def device(self) -> torch.device:
        return tree_device(self)

    def _add(self, key: str, make: Callable[[], Any]) -> None:
        """The subtree ``key`` from ``make()`` on the model's device, unless
        the tree holds it already."""
        if key in self:
            return
        if self._gen is None:
            raise ValueError(f"{key!r} is not in the tree and the model has "
                             f"no generator to draw it from")
        self.add_module(key, _node(make()))

    def _proj(self, key: str, in_dim: int) -> None:
        gen, device = self._gen, self.device
        self._add(key, lambda: {"w": init.magneto_output_projection(
            gen, (in_dim, self.decoder_config.embed_dim), device)})

    def register_modality(self, modality: str, *,
                          any_dim: Optional[int] = None) -> None:
        """Make the encoder and projection of ``modality`` now
        (kosmosx_tpu/models/any_modality.py:127-229). ``apply`` needs it
        (``forward`` registers by itself). ``any_dim``, the flattened
        per-sample size, shapes the "any" projection ``any_proj_{any_dim}``
        and is required for it."""
        if modality in self._encoders and (
                modality != "any" or any_dim is None
                or f"any_proj_{any_dim}" in self):
            return
        gen, device, dtype = self._gen, self.device, self.decoder_config.dtype
        if self.unified:
            from kosmosx_torch.nn.unified import (init_unified_encoder,
                                                  unified_encode)

            ucfg = self.unified_config
            self._add("unified_enc",
                      lambda: init_unified_encoder(gen, ucfg, device))
            self._proj("unified_proj", ucfg.hidden_dim)

            def encode(x, _m=modality):
                z = unified_encode(self["unified_enc"], x, _m, ucfg)
                return layers.linear(self["unified_proj"], z, dtype=dtype)

        elif modality == "image":
            from kosmosx_torch.nn.resampler import init_resampler, resampler
            from kosmosx_torch.nn.vision import clip_vit, init_clip_vit

            vcfg, rcfg = self.configs["image"]
            self._add("image_enc", lambda: {
                "clip": init_clip_vit(gen, vcfg, device),
                "resampler": init_resampler(gen, rcfg, device)})
            self._proj("image_proj", rcfg.dim)

            def encode(x):
                feats = clip_vit(self["image_enc"]["clip"], x, vcfg)
                lat = resampler(self["image_enc"]["resampler"], feats, rcfg)
                return layers.linear(self["image_proj"], lat[:, 0],
                                     dtype=dtype)

        elif modality == "audio":
            from kosmosx_torch.nn.audio import audio_encoder, init_audio_encoder

            acfg = self.configs["audio"]
            self._add("audio_enc", lambda: init_audio_encoder(gen, acfg, device))
            self._proj("audio_proj", acfg.hidden_dim)

            def encode(x):
                h = audio_encoder(self["audio_enc"], x, acfg)
                return layers.linear(self["audio_proj"],
                                     h.mean(dim=1, keepdim=True), dtype=dtype)

        elif modality == "video":
            from kosmosx_torch.nn.video import init_video_encoder, video_encoder

            vcfg = self.configs["video"]
            self._add("video_enc", lambda: init_video_encoder(gen, vcfg, device))
            self._proj("video_proj", vcfg.hidden_dim)

            def encode(x):
                h = video_encoder(self["video_enc"], x, vcfg)
                return layers.linear(self["video_proj"], h[:, None],
                                     dtype=dtype)

        else:  # "any": a flat per-sample projection
            if any_dim is None:
                raise ValueError(
                    "register_modality('any') needs any_dim= (the flattened "
                    "per-sample feature size) to shape its projection")
            self._proj(f"any_proj_{any_dim}", any_dim)

            def encode(x):
                flat = x.reshape(x.shape[0], -1)
                key = f"any_proj_{flat.shape[-1]}"
                if key not in self:
                    raise KeyError(
                        f"'any' input of flattened dim {flat.shape[-1]} was "
                        f"never registered — call register_modality('any', "
                        f"any_dim={flat.shape[-1]}) first")
                return layers.linear(self[key], flat[:, None], dtype=dtype)

        self._encoders[modality] = encode

    def apply(self, text_tokens: torch.Tensor,
              media: Sequence[Tuple[str, torch.Tensor]] = (),
              rng: Optional[int] = None) -> torch.Tensor:
        """Forward pass over ``media``, (modality, processed input) pairs of
        registered modalities -> logits (B, L + media tokens, vocab)
        (kosmosx_tpu/models/any_modality.py:232-258). Adds no parameter:
        an unregistered modality raises ``KeyError``. The dropout key
        ``rng`` splits into the spliced input's key and the layers'."""
        dcfg = self.decoder_config
        blocks = []
        for modality, processed in media:
            if modality not in self._encoders:
                raise KeyError(f"modality {modality!r} not registered — call "
                               f"register_modality({modality!r}) first")
            blocks.append(self._encoders[modality](processed))
        text_emb = dec.embed_only(self["decoder"], dcfg, text_tokens)
        spliced = text_emb
        if blocks:
            mediacat = torch.cat(blocks, dim=1).to(text_emb.dtype)
            spliced = torch.cat([text_emb[:, :1], mediacat, text_emb[:, 1:]],
                                dim=1)
        x, _ = dec.forward_embedding(self["decoder"], dcfg,
                                     token_embedding=spliced,
                                     rng=layers.fold_in(rng, 0))
        h = dec.run_layers(self["decoder"], x, dcfg, rng=layers.fold_in(rng, 1))
        return dec.output_logits(self["decoder"], h, dcfg)

    def prepare_media(self, media: Sequence[Tuple[Optional[str], Any]]):
        """Detect and preprocess each (modality or None, data) item,
        concurrently, then register each modality, serially and in order
        (kosmosx_tpu/models/any_modality.py:260-288). Returns the
        (modality, processed) list ``apply`` takes."""
        media = list(media)
        image_size = self.configs["image"][0].image_size

        def process(item):
            modality, data = item
            modality = modality or self.detector.detect(data)
            return modality, self.processor.process(modality, data,
                                                    image_size=image_size)

        if len(media) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(media))) as pool:
                prepared = list(pool.map(process, media))
        else:
            prepared = [process(item) for item in media]
        for modality, processed in prepared:
            any_dim = None
            if modality not in ("image", "audio", "video"):
                any_dim = int(np.prod(processed.shape[1:]))
            self.register_modality(modality, any_dim=any_dim)
        return prepared

    def forward(self, text_tokens, media: Sequence[Tuple[Optional[str], Any]]
                = (), rng: Optional[int] = None) -> torch.Tensor:
        """Register unseen modalities (the detector names a None modality),
        then ``apply`` (kosmosx_tpu/models/any_modality.py:290-296)."""
        prepared = self.prepare_media(media)
        return self.apply(torch.as_tensor(text_tokens, device=self.device),
                          media=prepared, rng=rng)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
