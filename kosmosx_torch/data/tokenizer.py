"""KosmosTokenizer: text and image preprocessing with ``<image>`` tag
splicing (counterpart of kosmosx_tpu/data/tokenizer.py).

- ``tokenize_texts(texts) -> (spliced_ids, raw_ids)``: one ``<tag></tag>``
  pair per modality inserted right after BOS, so that the model's splice at
  index 2 lands the image embeddings between the tags;
- ``tokenize_images(images) -> pixel_values`` through
  ``data/images.preprocess_images``, on the device of the images;
- ``tokenize(sample) -> {text_tokens, images, labels, attention_mask}``,
  the mask following the true spliced layout.

Backends: a HF tokenizer where ``transformers`` finds one on this machine
(a local ``tokenizer.json``, a local directory or a name already in the
cache: nothing is downloaded), else the self-contained byte-level
tokenizer with the same special-token layout. Both use fairseq-style ids:
bos=0, pad=1, eos=2. Ids and masks are the JAX package's.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from kosmosx_torch.data.images import preprocess_images

logger = logging.getLogger(__name__)


class ByteTokenizer:
    """Deterministic byte-level tokenizer (kosmosx_tpu/data/tokenizer.py:
    36-92). Layout: bos=0, pad=1, eos=2, unk=3, bytes 4..259, then the
    special tokens."""

    def __init__(self, extra_special_tokens: Sequence[str] = ()):
        self.bos_token_id = 0
        self.pad_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 3
        self._byte_offset = 4
        self._specials: Dict[str, int] = {}
        for tok in extra_special_tokens:
            self.add_special_token(tok)

    def add_special_token(self, tok: str) -> int:
        if tok not in self._specials:
            self._specials[tok] = self._byte_offset + 256 + len(self._specials)
        return self._specials[tok]

    def convert_tokens_to_ids(self, tok: str) -> int:
        return self._specials.get(tok, self.unk_token_id)

    @property
    def vocab_size(self) -> int:
        return self._byte_offset + 256 + len(self._specials)

    def encode(self, text: str, *, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = [self._byte_offset + b for b in text.encode("utf-8")]
        if add_bos:
            ids = [self.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Bytes and special tokens back to text; bos, pad, eos and unk are
        dropped."""
        inv = {v: k for k, v in self._specials.items()}
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if self._byte_offset <= i < self._byte_offset + 256:
                byte_buf.append(i - self._byte_offset)
            elif i in inv:
                flush()
                out.append(inv[i])
        flush()
        return "".join(out)


def _try_hf_tokenizer(name: str, model_max_length: int):
    """A HF tokenizer for ``name`` from this machine only: a local
    ``tokenizer.json``, a local directory or a name in the HF cache
    (``local_files_only``); None where ``transformers`` is missing or finds
    nothing (kosmosx_tpu/data/tokenizer.py:95-125, with no download)."""
    try:
        if os.path.isfile(name) and name.endswith(".json"):
            from transformers import PreTrainedTokenizerFast

            return PreTrainedTokenizerFast(tokenizer_file=name,
                                           model_max_length=model_max_length)
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            name, additional_special_tokens=[], extra_ids=0,
            model_max_length=model_max_length, local_files_only=True)
    except (ImportError, OSError, ValueError) as e:
        logger.info("HF tokenizer %r unavailable (%s); using the byte "
                    "tokenizer", name, type(e).__name__)
        return None


class KosmosTokenizer:
    """Multimodal preprocessing (kosmosx_tpu/data/tokenizer.py:128-258)."""

    IMAGE_TOKEN = "<image>"
    IMAGE_END_TOKEN = "</image>"
    MODALITY_TAGS = {
        "image": ("<image>", "</image>"),
        "audio": ("<audio>", "</audio>"),
        "video": ("<video>", "</video>"),
        "any": ("<any>", "</any>"),
    }

    def __init__(self, tokenizer_name: str = "EleutherAI/gpt-neox-20b",
                 model_max_length: int = 8192, image_size: int = 224,
                 image_embed_len: int = 64,
                 modalities: Sequence[str] = ("image",), use_hf: bool = True):
        self.image_size = image_size
        self.image_embed_len = image_embed_len
        self.modalities = tuple(modalities)
        tags: List[str] = []
        for m in self.modalities:
            tags.extend(self.MODALITY_TAGS[m])
        self.hf = (_try_hf_tokenizer(tokenizer_name, model_max_length)
                   if use_hf else None)
        if self.hf is not None:
            self.hf.add_tokens(tags)
            self._tag_ids = {t: self.hf.convert_tokens_to_ids(t) for t in tags}
            # GPT-NeoX has no pad token and eos id 0: explicit None checks
            if self.hf.pad_token_id is None:
                if self.hf.eos_token is not None:
                    self.hf.pad_token = self.hf.eos_token
                else:
                    self.hf.add_special_tokens({"pad_token": "<|pad|>"})
            self.pad_token_id = self.hf.pad_token_id
            bos = getattr(self.hf, "bos_token_id", None)
            self.bos_token_id = bos if bos is not None else 0
            eos = getattr(self.hf, "eos_token_id", None)
            self.eos_token_id = eos if eos is not None else 2
            self.vocab_size = len(self.hf)
        else:
            self.byte = ByteTokenizer(tags)
            self._tag_ids = {t: self.byte.convert_tokens_to_ids(t) for t in tags}
            self.pad_token_id = self.byte.pad_token_id
            self.bos_token_id = self.byte.bos_token_id
            self.eos_token_id = self.byte.eos_token_id
            self.vocab_size = self.byte.vocab_size
        self.im_idx = self._tag_ids.get(self.IMAGE_TOKEN)
        self.im_end_idx = self._tag_ids.get(self.IMAGE_END_TOKEN)
        self.model_max_length = model_max_length

    def _encode_batch(self, texts: Sequence[str], max_length: Optional[int]):
        if self.hf is not None:
            enc = self.hf(list(texts), return_tensors="np", padding=True,
                          truncation=True,
                          max_length=max_length or self.model_max_length)
            ids = enc["input_ids"].astype(np.int32)
            # a BOS at position 0 (the NeoX tokenizer adds none)
            if ids.shape[1] == 0 or not np.all(ids[:, 0] == self.bos_token_id):
                bos = np.full((ids.shape[0], 1), self.bos_token_id, np.int32)
                ids = np.concatenate([bos, ids], axis=1)
            return ids
        cap = max_length or self.model_max_length
        encoded = [self.byte.encode(t)[:cap] for t in texts]
        out = np.full((len(encoded), max(len(e) for e in encoded)),
                      self.pad_token_id, np.int32)
        for i, e in enumerate(encoded):
            out[i, :len(e)] = e
        return out

    def tokenize_texts(self, texts: Union[str, Sequence[str]],
                       max_length: Optional[int] = None,
                       modalities: Optional[Sequence[str]] = None):
        """-> (spliced_ids (B, L + 2M), raw_ids (B, L)) as int32 numpy
        arrays: one ``<tag></tag>`` pair per modality after BOS."""
        if isinstance(texts, str):
            texts = [texts]
        raw = self._encode_batch(texts, max_length)
        modalities = modalities if modalities is not None else self.modalities
        tag_row: List[int] = []
        for m in modalities:
            open_t, close_t = self.MODALITY_TAGS[m]
            tag_row += [self._tag_ids[open_t], self._tag_ids[close_t]]
        tags = np.tile(np.array([tag_row], np.int32), (raw.shape[0], 1))
        return np.concatenate([raw[:, :1], tags, raw[:, 1:]], axis=1), raw

    def tokenize_images(self, images) -> torch.Tensor:
        """(B, 3, H, W) uint8 or float -> CLIP-normalised pixel values
        (B, 3, image_size, image_size), on the device of ``images`` (a numpy
        array: the CPU)."""
        return preprocess_images(torch.as_tensor(images),
                                 image_size=self.image_size)

    def tokenize(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """{"target_text", "image"} -> {text_tokens, images, labels,
        attention_mask}; the mask follows the spliced layout [BOS, <image>,
        image_embed_len image positions, </image>, text, pad]."""
        text_tokens, raw = self.tokenize_texts(sample["target_text"])
        b = text_tokens.shape[0]
        text_mask = text_tokens != self.pad_token_id
        attention_mask = np.concatenate(
            [text_mask[:, :2], np.ones((b, self.image_embed_len), bool),
             text_mask[:, 2:]], axis=1)
        return {
            "text_tokens": text_tokens,
            "images": self.tokenize_images(sample["image"]),
            "labels": raw,
            "attention_mask": attention_mask.astype(np.int32),
        }

    def decode(self, ids) -> str:
        ids = np.asarray(torch.as_tensor(ids).cpu()).reshape(-1)
        if self.hf is not None:
            return self.hf.decode([int(i) for i in ids
                                   if int(i) != self.pad_token_id],
                                  skip_special_tokens=False)
        return self.byte.decode(ids)
