"""Magneto multihead self-attention: sub-LN, xPos, multiway
(counterpart of kosmosx_tpu/nn/attention.py).

Two branches, with the JAX dispatch rules:

- full sequence (no cache, kosmosx_tpu/nn/attention.py:311-334): the flash
  kernel with xPos fused at center ``L // 2`` once ``L >= 256``, plain
  attention with xPos applied outside below that;
- append-mode KV cache (:335-442): xPos at the absolute position
  ``cache_index`` with center 0, padded chunk positions zeroed, the new K/V
  written into the cache at ``cache_index`` IN PLACE, then the prefill runs
  the flash kernel (no fused xPos: q/k are rotated already) and a one-token
  decode step runs the decode kernel when ``decode_attn_kernel`` is set, at
  any cache length; everything else runs plain attention over the cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from kosmosx_torch.core.config import not_ported
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.multiway import init_multiway, multiway_apply
from kosmosx_torch.nn.xpos import apply_xpos
from kosmosx_torch.ops.decode_attention import decode_attention
from kosmosx_torch.ops.flash_attention import flash_attention

# kosmosx_tpu/nn/attention.py:39: shorter sequences take the plain path
_FLASH_MIN_LEN = 256


def init_self_attention(gen, embed_dim: int, heads: int, *, subln: bool = True,
                        multiway: bool = False, device=None):
    """q/k/v xavier with gain 1/sqrt(2), out with gain 1
    (kosmosx_tpu/nn/attention.py:42-62)."""
    def make_linear(gain):
        return lambda g: layers.init_linear(g, embed_dim, embed_dim, gain=gain,
                                            device=device)

    gain = 1.0 / math.sqrt(2.0)
    params = {
        "q": init_multiway(multiway, gen, make_linear(gain)),
        "k": init_multiway(multiway, gen, make_linear(gain)),
        "v": init_multiway(multiway, gen, make_linear(gain)),
        "out": init_multiway(multiway, gen, make_linear(1.0)),
    }
    if subln:
        params["inner_ln"] = init_multiway(
            multiway, gen,
            lambda g: layers.init_layer_norm(embed_dim, device=device))
    return params


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)  # (B,H,L,hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def plain_attention(q, k, v, *, causal: bool,
                    kv_len: Optional[torch.Tensor] = None,
                    segment_q: Optional[torch.Tensor] = None,
                    segment_kv: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,H,Lq,hd) attention with an fp32 softmax
    (``_jnp_attention``, kosmosx_tpu/nn/attention.py:85-161, without its
    dropout, int8 and shared-prefix options). ``kv_len`` (B,) masks cache
    positions at or past it; ``q_offset`` (B,) is the absolute position of
    q[:, :, 0] for the causal mask against a cache. A fully masked row is a
    uniform softmax (mask value ``finfo.min``), as in JAX."""
    lq, lk = q.shape[-2], k.shape[-2]
    dev = q.device
    s = q.float() @ k.float().transpose(-1, -2)
    mask = None
    if causal and (lq > 1 or q_offset is not None):
        kj = torch.arange(lk, device=dev)
        if q_offset is not None:
            qi = q_offset[:, None, None, None] + torch.arange(
                lq, device=dev)[None, None, :, None]
            mask = kj[None, None, None, :] <= qi
        else:
            qi = torch.arange(lq, device=dev)[:, None] + (lk - lq)
            mask = (kj[None, :] <= qi)[None, None]
    if kv_len is not None:
        valid = (torch.arange(lk, device=dev)[None, None, None, :]
                 < kv_len[:, None, None, None])
        mask = valid if mask is None else mask & valid
    if segment_q is not None:
        seg = segment_q[:, None, :, None] == segment_kv[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return p.to(v.dtype) @ v


def self_attention(params, x: torch.Tensor, *, heads: int, subln: bool = True,
                   multiway: bool = False, split: Optional[int] = None,
                   causal: bool = True, xpos: bool = True,
                   xpos_scale_base: int = 512, use_flash: bool = True,
                   segment_ids: Optional[torch.Tensor] = None,
                   attn_dropout: float = 0.0,
                   rng: Optional[torch.Generator] = None,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index=None, prefill: bool = False,
                   shared_kv=None, kv_window: int = 0,
                   decode_attn_kernel: bool = False, dtype=None,
                   sequence_axis: Optional[str] = None) -> torch.Tensor:
    """Self-attention over ``x`` (B, L, D) -> (B, L, D).

    KV cache: ``cache = {"k", "v"}`` of shape (B, H, Lmax, hd) and
    ``cache_index`` (B,) or scalar, the number of tokens already cached. The
    new keys and values are written into ``cache`` in place at
    ``cache_index``; attention then covers the valid prefix of the cache.
    The prefill contract is the JAX one: it writes at index 0."""
    if sequence_axis is not None:
        raise not_ported("sequence parallelism (sequence_axis)",
                         "Queue 1 item 10")
    if shared_kv is not None:
        raise not_ported("shared-prefix attention (shared_kv)",
                         "Queue 1 item 5")
    if rng is not None and attn_dropout > 0.0:
        raise not_ported("dropout with an rng", "Queue 1 item 6")
    b, l, d = x.shape

    def proj(p, t):
        return multiway_apply(multiway,
                              lambda pp, xx: layers.linear(pp, xx, dtype=dtype),
                              p, t, split)

    q = _split_heads(proj(params["q"], x) * (d // heads) ** -0.5, heads)
    k = _split_heads(proj(params["k"], x), heads)
    v = _split_heads(proj(params["v"], x), heads)

    if cache is None:
        if use_flash and l >= _FLASH_MIN_LEN:
            # xPos rotation and decay fused into the kernel's tile loads
            o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, sm_scale=1.0,
                                q_segment_ids=segment_ids,
                                kv_segment_ids=segment_ids,
                                xpos_scale_base=(xpos_scale_base if xpos
                                                 else None))
        else:
            if xpos:
                center = l // 2  # torchscale centering; cancels in q.k
                q = apply_xpos(q, scale_base=xpos_scale_base, center=center)
                k = apply_xpos(k, scale_base=xpos_scale_base, downscale=True,
                               center=center)
            o = plain_attention(q, k, v, causal=causal, segment_q=segment_ids,
                                segment_kv=segment_ids)
    else:
        if kv_window > 0:
            raise not_ported("the rolling KV window (kv_window > 0)",
                             "Queue 1 item 5")
        if "k_scale" in cache:
            raise not_ported("the int8 KV cache write path", "Queue 1 item 5")
        idx = torch.as_tensor(cache_index, device=x.device).long()
        if idx.ndim == 0:
            idx = idx.expand(b)
        if xpos:
            # absolute positions, center fixed at 0 so cached keys stay valid
            q = apply_xpos(q, offset=idx, scale_base=xpos_scale_base, center=0)
            k = apply_xpos(k, offset=idx, scale_base=xpos_scale_base,
                           downscale=True, center=0)
        if segment_ids is not None:
            # padded chunk positions are written as zeros
            valid = (segment_ids >= 0).to(k.dtype)[:, None, :, None]
            k = k * valid
            v = v * valid
        pos = idx[:, None] + torch.arange(l, device=x.device)[None, :]  # (B,L)
        b_idx = torch.arange(b, device=x.device)[:, None]
        # advanced indices (B, L) around the head slice put (B, L) first:
        # the value is laid out (B, L, H, hd)
        cache["k"][b_idx, :, pos, :] = k.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][b_idx, :, pos, :] = v.transpose(1, 2).to(cache["v"].dtype)
        kv_len = idx + l
        if prefill and use_flash and l >= _FLASH_MIN_LEN:
            # attention over the cache == causal attention over the chunk
            o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True, sm_scale=1.0,
                                q_segment_ids=segment_ids,
                                kv_segment_ids=segment_ids)
        elif decode_attn_kernel and l == 1:
            # the causal mask is the kv_len mask at one query per row. The
            # JAX rule's cache shape conditions (:414-416) are limits of the
            # Pallas kernel; the CUDA kernel takes any cache length.
            o = decode_attention(q.contiguous(), cache["k"], cache["v"], kv_len)
        else:
            o = plain_attention(q, cache["k"], cache["v"], causal=causal,
                                kv_len=kv_len, q_offset=idx)
    o = _merge_heads(o.to(x.dtype))
    if subln and "inner_ln" in params:
        o = multiway_apply(multiway, layers.layer_norm, params["inner_ln"], o,
                           split)
    return proj(params["out"], o)
