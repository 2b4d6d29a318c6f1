"""Synthetic training batches and their transfer to the device (counterpart
of kosmosx_tpu/train/data.py:339-370 and ``device_prefetch``, :230).

The generators are numpy ``RandomState`` streams, as in the JAX package, so
they yield the same arrays for the same seed. ``device_prefetch`` replaces
the JAX package's background transfer thread: each batch is copied from
pinned host memory with ``non_blocking=True``, one batch ahead of the step
that consumes it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


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
