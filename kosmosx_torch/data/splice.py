"""Splicing image embeddings into token-embedding sequences
(counterpart of kosmosx_tpu/data/splice.py).

Image block m (K embeddings) goes right after text position
``positions[b, m]`` (its <image> token); with no positions, one image sits
at the static ``index`` (the reference's ``cat([emb[:, :2], image,
emb[:, 2:]])``) and several images take the default back-to-back tag
positions. The output length is ``L_text + M*K``.
"""

from __future__ import annotations

from typing import Optional

import torch


def splice_single(text_emb: torch.Tensor, image_emb: torch.Tensor,
                  index: int = 2) -> torch.Tensor:
    """kosmosx_tpu/data/splice.py:28-34."""
    return torch.cat([text_emb[:, :index], image_emb.to(text_emb.dtype),
                      text_emb[:, index:]], dim=1)


def splice_plan(positions: torch.Tensor, text_len: int, num_images: int,
                block: int) -> torch.Tensor:
    """gather_idx (B, L_out) indexing into ``cat([text, images.flat], 1)``
    (kosmosx_tpu/data/splice.py:37-68; its ``is_image`` output has no user
    here)."""
    b, m = positions.shape
    dev = positions.device
    out_len = text_len + num_images * block
    j = torch.arange(text_len, device=dev)[None, :]
    shifts = (positions[:, :, None] < j[:, None, :]).sum(dim=1)
    text_tgt = j + block * shifts                              # (B, Lt)
    k = torch.arange(block, device=dev)[None, None, :]
    m_idx = torch.arange(num_images, device=dev)[None, :, None]
    img_tgt = (positions[:, :, None] + 1 + block * m_idx + k).reshape(
        b, num_images * block)
    batch_idx = torch.arange(b, device=dev)[:, None]
    gather_idx = torch.zeros((b, out_len), dtype=torch.long, device=dev)
    gather_idx[batch_idx, text_tgt] = torch.arange(text_len, device=dev).expand(
        b, text_len)
    gather_idx[batch_idx, img_tgt] = text_len + torch.arange(
        num_images * block, device=dev).expand(b, num_images * block)
    return gather_idx


def _default_positions(b: int, m: int, index: int, text_len: int,
                       device=None) -> torch.Tensor:
    """The m-th <image> token at text position ``index - 1 + 2m``
    (kosmosx_tpu/data/splice.py:71-82)."""
    last = index - 1 + 2 * (m - 1)
    if last >= text_len:
        raise ValueError(
            f"{m} default image positions (last at text index {last}) do not "
            f"fit a length-{text_len} text; pass explicit `image_positions`")
    return (index - 1 + 2 * torch.arange(m, device=device)).expand(b, m)


def splice_embeddings(text_emb: torch.Tensor, image_emb: torch.Tensor,
                      positions: Optional[torch.Tensor] = None,
                      index: int = 2) -> torch.Tensor:
    """text_emb (B, Lt, D); image_emb (B, K, D) or (B, M, K, D); positions
    (B, M) or None (kosmosx_tpu/data/splice.py:85-102)."""
    if image_emb.ndim == 3:
        image_emb = image_emb[:, None]
    b, m, k, d = image_emb.shape
    lt = text_emb.shape[1]
    if positions is None:
        if m == 1:
            return splice_single(text_emb, image_emb[:, 0], index)
        positions = _default_positions(b, m, index, lt, text_emb.device)
    gather_idx = splice_plan(positions.long(), lt, m, k)
    src = torch.cat([text_emb, image_emb.to(text_emb.dtype).reshape(b, m * k, d)],
                    dim=1)
    return torch.gather(src, 1, gather_idx[:, :, None].expand(-1, -1, d))


def spliced_segment_ids(tokens: torch.Tensor, padding_idx: int,
                        num_images: int, block: int,
                        positions: Optional[torch.Tensor] = None,
                        index: int = 2) -> torch.Tensor:
    """0 for text tokens and image embeddings, -1 for padding, shape
    (B, Lt + M*K) (kosmosx_tpu/data/splice.py:105-120)."""
    b, lt = tokens.shape
    if positions is None:
        positions = _default_positions(b, num_images, index, lt, tokens.device)
    gather_idx = splice_plan(positions.long(), lt, num_images, block)
    src = torch.cat([tokens != padding_idx,
                     torch.ones((b, num_images * block), dtype=torch.bool,
                                device=tokens.device)], dim=1)
    valid = torch.gather(src, 1, gather_idx)
    return torch.where(valid, 0, -1).to(torch.int32)
