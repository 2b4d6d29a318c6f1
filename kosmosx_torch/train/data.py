"""Training data (counterpart of kosmosx_tpu/train/data.py): the real-data
loaders, the synthetic generators, and the transfer of batches to the
device.

The loaders yield numpy dicts with JAX's semantics byte for byte:
``group_texts`` concatenates tokenized documents with an EOS after each,
carries the remainder across calls and drops the last partial block (the
packing runs through the port's native binding, ``data/native``, or its
numpy version); the pretokenized stream re-chunks ``.npy`` (memmapped) and
``.bin`` token files (dtype from the argument, a ``<stem>.json`` sidecar,
or uint16) across file boundaries; the image+caption loader reads a JSONL
manifest beside ``.npy`` or PIL images and tokenizes through the port's
``data/tokenizer.py``. The synthetic generators are numpy ``RandomState``
streams, so they yield the same arrays as JAX's for the same seed.
``device_prefetch`` replaces the JAX package's background transfer
thread: each batch is copied from pinned host memory with
``non_blocking=True``, one batch ahead of the step that consumes it.
"""

from __future__ import annotations

import json
import os
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import numpy as np
import torch


# ---------------------------------------------------------------------------
# packed text (kosmosx_tpu/train/data.py:23-66)
# ---------------------------------------------------------------------------


def group_texts(token_streams: Iterable[Sequence[int]], seq_len: int,
                eos_id: int = 2) -> Iterator[np.ndarray]:
    """Concatenate tokenized docs, an EOS after each, and yield ``seq_len``
    int32 blocks, dropping the trailing remainder. Docs are packed in
    batches of at least ``max(64 * seq_len, 65536)`` tokens through
    ``data.native.pack_blocks``."""
    from kosmosx_torch.data import native

    carry = np.zeros((0,), np.int32)
    pending: List[np.ndarray] = []
    pending_tokens = 0
    flush_at = max(seq_len * 64, 1 << 16)  # one library call per batch
    for stream in token_streams:
        doc = np.asarray(stream, np.int32).ravel()
        pending.append(doc)
        pending_tokens += len(doc) + 1
        if pending_tokens + len(carry) >= flush_at:
            blocks, carry = native.pack_blocks(pending, seq_len, eos_id, carry)
            pending, pending_tokens = [], 0
            yield from blocks
    if pending:
        blocks, carry = native.pack_blocks(pending, seq_len, eos_id, carry)
        yield from blocks


def _batched(block_iter: Iterator[np.ndarray],
             batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
    """``{"input_ids": (B, L), "attention_mask": ones}`` from blocks; a last
    partial batch is dropped."""
    while True:
        blocks = []
        for _ in range(batch_size):
            try:
                blocks.append(next(block_iter))
            except StopIteration:
                return
        ids = np.stack(blocks)
        yield {"input_ids": ids,
               "attention_mask": np.ones_like(ids, np.int32)}


def packed_text_batches(token_streams: Iterable[Sequence[int]], *,
                        batch_size: int, seq_len: int,
                        eos_id: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """``{"input_ids", "attention_mask"}`` batches of ``group_texts``
    blocks."""
    return _batched(group_texts(token_streams, seq_len, eos_id), batch_size)


# ---------------------------------------------------------------------------
# pretokenized token files (kosmosx_tpu/train/data.py:69-139)
# ---------------------------------------------------------------------------


def _open_token_file(path: str, dtype: Optional[str] = None) -> np.ndarray:
    """A token file, not loaded into memory: ``.npy`` memmapped (a 1-D
    stream or (N, L) rows); anything else a raw ``np.memmap`` of ``dtype``,
    else the ``{"dtype": ...}`` of a ``<stem>.json`` sidecar, else
    uint16."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    dt = dtype
    if dt is None:
        sidecar = os.path.splitext(path)[0] + ".json"
        if os.path.exists(sidecar):
            with open(sidecar, "r", encoding="utf-8") as f:
                dt = json.load(f).get("dtype")
    return np.memmap(path, dtype=np.dtype(dt or "uint16"), mode="r")


def pretokenized_stream(paths: Sequence[str], *, seq_len: int,
                        dtype: Optional[str] = None,
                        slab_tokens: int = 1 << 20) -> Iterator[np.ndarray]:
    """``seq_len`` int32 blocks of the files' tokens concatenated (the
    remainder carried across files, the last one dropped), read through
    ``slab_tokens``-sized memmap slices."""
    carry = np.zeros((0,), np.int32)
    for path in paths:
        flat = _open_token_file(path, dtype).reshape(-1)
        pos = 0
        while pos < flat.shape[0]:
            slab = np.asarray(flat[pos:pos + slab_tokens], np.int32)
            pos += slab.shape[0]
            if carry.size:
                slab = np.concatenate([carry, slab])
            nblocks = slab.shape[0] // seq_len
            for i in range(nblocks):
                yield slab[i * seq_len:(i + 1) * seq_len].copy()
            carry = slab[nblocks * seq_len:]


def pretokenized_batches(paths: Sequence[str], *, batch_size: int,
                         seq_len: int, dtype: Optional[str] = None,
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """``{"input_ids", "attention_mask"}`` batches of
    ``pretokenized_stream`` blocks."""
    return _batched(pretokenized_stream(paths, seq_len=seq_len, dtype=dtype),
                    batch_size)


# ---------------------------------------------------------------------------
# image + caption datasets (kosmosx_tpu/train/data.py:142-227, 380-417)
# ---------------------------------------------------------------------------


def _load_image_file(path: str, image_size: Optional[int]) -> np.ndarray:
    """One image as channel-first (3, H, W): a ``.npy`` array ((3, H, W),
    (H, W, C) or (H, W)) as it is, which must already be ``image_size``
    square; any other file through PIL, converted to RGB uint8 and, when
    its size differs, the short side resized bicubically to ``image_size``
    and center-cropped."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=0)
        if img.ndim == 3 and img.shape[0] not in (1, 3):
            img = img[..., :3].transpose(2, 0, 1)
        if img.shape[0] == 1:
            img = np.repeat(img, 3, axis=0)
        if image_size is not None and img.shape[-2:] != (image_size, image_size):
            raise ValueError(
                f"{path}: npy image is {img.shape[-2:]}, expected "
                f"({image_size}, {image_size}): pre-size npy images")
        return img
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if image_size is not None and im.size != (image_size, image_size):
            w, h = im.size
            scale = image_size / min(w, h)
            nw = max(image_size, round(w * scale))
            nh = max(image_size, round(h * scale))
            im = im.resize((nw, nh), Image.BICUBIC)
            left = (nw - image_size) // 2
            top = (nh - image_size) // 2
            im = im.crop((left, top, left + image_size, top + image_size))
        return np.asarray(im, np.uint8).transpose(2, 0, 1)


def image_caption_samples(root: str, *, captions_file: str = "captions.jsonl",
                          image_size: Optional[int] = 224,
                          ) -> Iterator[Dict[str, Any]]:
    """``{"target_text", "image"}`` samples of a directory holding a JSONL
    manifest, one ``{"image": path, "text": caption}`` a line (``caption``
    / ``target_text`` and ``file`` / ``image_path`` accepted too; a
    relative path is under ``root``)."""
    manifest = os.path.join(root, captions_file)
    with open(manifest, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            text = rec.get("text") or rec.get("caption") or rec.get("target_text")
            img_rel = rec.get("image") or rec.get("file") or rec.get("image_path")
            if text is None or img_rel is None:
                raise ValueError(f"{manifest}: record missing text/image: {rec}")
            img_path = img_rel if os.path.isabs(img_rel) else \
                os.path.join(root, img_rel)
            yield {"target_text": text,
                   "image": _load_image_file(img_path, image_size)}


def image_caption_batches(root: str, tokenizer, *, batch_size: int,
                          text_len: int,
                          captions_file: str = "captions.jsonl",
                          image_size: Optional[int] = None,
                          epochs: Optional[int] = 1,
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """``{"text_tokens", "images"}`` batches of ``image_caption_samples``
    through ``multimodal_batches``; ``epochs=None`` loops forever."""
    if image_size is None:
        image_size = getattr(tokenizer, "image_size", 224)
    epoch = 0
    while epochs is None or epoch < epochs:
        samples = image_caption_samples(root, captions_file=captions_file,
                                        image_size=image_size)
        yield from multimodal_batches(samples, tokenizer,
                                      batch_size=batch_size,
                                      text_len=text_len)
        epoch += 1


def multimodal_batches(samples: Iterable[Dict[str, Any]], tokenizer, *,
                       batch_size: int, text_len: int,
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """``{"text_tokens": (B, text_len) int32, "images": (B, 3, S, S) fp32}``
    of raw ``{"target_text", "image"}`` samples: each caption through
    ``tokenizer.tokenize_texts`` (BOS, one tag pair per modality, the
    caption encoded to at most ``text_len - (1 + 2 * modalities)`` tokens)
    and padded to ``text_len``; the images CLIP-normalised by
    ``tokenizer.tokenize_images`` on the CPU. A last partial batch is
    dropped."""
    pad = tokenizer.pad_token_id
    reserve = 1 + 2 * len(tokenizer.modalities)
    batch_toks: List[np.ndarray] = []
    batch_imgs: List[np.ndarray] = []
    for sample in samples:
        ids, _ = tokenizer.tokenize_texts(sample["target_text"],
                                          max_length=max(1, text_len - reserve))
        row = np.full((text_len,), pad, np.int32)
        n = min(ids.shape[1], text_len)
        row[:n] = ids[0, :n]
        batch_toks.append(row)
        img = np.asarray(sample["image"])
        if img.ndim == 3:
            img = img[None]
        batch_imgs.append(img[0])
        if len(batch_toks) == batch_size:
            pixels = tokenizer.tokenize_images(torch.from_numpy(
                np.stack(batch_imgs)))
            yield {"text_tokens": np.stack(batch_toks),
                   "images": np.asarray(pixels.cpu().numpy(), np.float32)}
            batch_toks, batch_imgs = [], []


# ---------------------------------------------------------------------------
# document streams (kosmosx_tpu/train/data.py:278-336)
# ---------------------------------------------------------------------------


def _encode_doc(tokenizer, text: str) -> List[int]:
    if getattr(tokenizer, "hf", None) is not None:
        return tokenizer.hf(text)["input_ids"]
    if hasattr(tokenizer, "byte"):
        return tokenizer.byte.encode(text)
    return tokenizer.encode(text)


def text_file_stream(paths: Sequence[str], tokenizer) -> Iterator[List[int]]:
    """Tokenized documents, one per non-empty line of each text file."""
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                yield _encode_doc(tokenizer, line)


def hf_dataset_stream(name: str, tokenizer, *, split: str = "train",
                      text_key: str = "text", streaming: bool = True,
                      config: Optional[str] = None) -> Iterator[List[int]]:
    """Tokenized documents of a Hugging Face dataset (its ``text_key``
    field, empty ones skipped), for ``packed_text_batches``. Needs the
    ``datasets`` package and the dataset in its local cache; it is
    imported at the first item, as in JAX."""
    try:
        from datasets import load_dataset  # type: ignore
    except Exception as e:
        raise ImportError(
            "hf_dataset_stream needs the `datasets` package and a cached "
            "dataset") from e
    ds = (load_dataset(name, config, split=split, streaming=streaming)
          if config is not None else
          load_dataset(name, split=split, streaming=streaming))
    for ex in ds:
        text = ex.get(text_key) if hasattr(ex, "get") else ex[text_key]
        if not text:
            continue
        yield _encode_doc(tokenizer, text)


def shard_stream(it: Iterable, index: int, count: int) -> Iterator:
    """Items ``i % count == index`` of a stream: process ``index`` of
    ``count``'s round-robin share."""
    if not (0 <= index < count):
        raise ValueError(f"bad shard index {index} of {count}")
    for i, item in enumerate(it):
        if i % count == index:
            yield item


def preference_jsonl_batches(path: str, tokenizer, *, batch_size: int,
                             length: int, epochs: Optional[int] = 1
                             ) -> Iterator[Dict[str, np.ndarray]]:
    """DPO preference batches from a JSONL file of ``{"prompt", "chosen",
    "rejected"}`` text rows, tokenized and collated by
    ``train/dpo.preference_batch`` (kosmosx_tpu/train/data.py:413-443); a
    trailing partial batch is dropped. Attach the frozen reference's
    log-probs afterwards with ``train/dpo.compute_ref_logprobs``."""
    from kosmosx_torch.train.dpo import preference_batch

    epoch = 0
    while epochs is None or epoch < epochs:
        epoch += 1
        prompts, chosen, rejected = [], [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                prompts.append(_encode_doc(tokenizer, row["prompt"]))
                chosen.append(_encode_doc(tokenizer, row["chosen"]))
                rejected.append(_encode_doc(tokenizer, row["rejected"]))
                if len(prompts) == batch_size:
                    yield preference_batch(prompts, chosen, rejected,
                                           length=length)
                    prompts, chosen, rejected = [], [], []


# ---------------------------------------------------------------------------
# synthetic batches (kosmosx_tpu/train/data.py:339-377)
# ---------------------------------------------------------------------------


def synthetic_text_batches(*, batch_size: int, seq_len: int, vocab_size: int,
                           seed: int = 0, steps: Optional[int] = None
                           ) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic LM batches with learnable structure (each token a
    function of the previous one), ``{"input_ids", "attention_mask"}``."""
    rng = np.random.RandomState(seed)
    i = 0
    while steps is None or i < steps:
        start = rng.randint(2, vocab_size, size=(batch_size, 1))
        step = rng.randint(1, 7, size=(batch_size, 1))
        seq = (start + step * np.arange(seq_len)[None, :]) % (vocab_size - 2) + 2
        yield {"input_ids": seq.astype(np.int32),
               "attention_mask": np.ones((batch_size, seq_len), np.int32)}
        i += 1


def synthetic_multimodal_batches(*, batch_size: int, seq_len: int,
                                 vocab_size: int, image_size: int = 224,
                                 seed: int = 0, steps: Optional[int] = None
                                 ) -> Iterator[Dict[str, np.ndarray]]:
    """``{"text_tokens", "images"}`` batches for the Kosmos train path: BOS
    (0) then uniform tokens, and uniform [0, 1) pixels."""
    rng = np.random.RandomState(seed)
    i = 0
    while steps is None or i < steps:
        toks = rng.randint(4, vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        toks[:, 0] = 0  # BOS
        imgs = rng.rand(batch_size, 3, image_size, image_size).astype(np.float32)
        yield {"text_tokens": toks, "images": imgs}
        i += 1


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``device``; for a CUDA device
    through pinned host memory with a non-blocking copy."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def device_prefetch(iterator: Iterable, place_fn: Callable) -> Iterator:
    """Apply ``place_fn`` (the host-to-device transfer) one item ahead of
    consumption, so the copy of the next batch is queued before the current
    step runs. Callers that stop early bound ``iterator`` first, as
    ``Trainer.run`` does."""
    ahead = []
    for item in iterator:
        ahead.append(place_fn(item))
        if len(ahead) > 1:
            yield ahead.pop(0)
    yield from ahead
