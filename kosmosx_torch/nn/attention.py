"""Magneto multihead self-attention: sub-LN, xPos, multiway
(counterpart of kosmosx_tpu/nn/attention.py).

Two branches, with the JAX dispatch rules:

- full sequence (no cache, kosmosx_tpu/nn/attention.py:311-334): the flash
  kernel with xPos fused at center ``L // 2`` once ``L >= 256``, plain
  attention with xPos applied outside below that and wherever attention
  dropout runs (a key ``rng`` and ``attn_dropout > 0``: the kernels have
  no dropout);
- KV cache (:335-442): xPos at the absolute position ``cache_index`` (plus
  ``pos_offset``) with center 0 or ``xpos_center``, padded chunk positions
  zeroed, the new K/V written into the cache IN PLACE: at ``cache_index``,
  or for a one-token step under ``kv_window`` at its ring slot (sink slots
  first, then a ring over the rest), as int8 codes with fp32 scales where
  the cache holds ``k_scale``/``v_scale``. Then a prefill of 256 positions
  or more runs the flash kernel (no fused xPos: q/k are rotated already),
  a one-token step runs the decode kernel when ``decode_attn_kernel`` is
  set, at any cache length, on int8 and ring caches too; everything else,
  and anything with a shared prefix (``shared_kv``), runs plain attention
  over the cache;
- sequence parallel (``sequence_axis``, :160-310): x is this rank's shard
  of the sequence over ``sequence_group``; q and k are rotated with their
  global positions (contiguous shards, or the zigzag layout's two chunks),
  then the ring or zigzag ring of ``parallel/ring_attention.py`` runs the
  flash kernels, or under attention dropout ``_gathered_sp_attention``
  attends over all-gathered K/V.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from kosmosx_torch.nn import layers
from kosmosx_torch.nn.multiway import init_multiway, multiway_apply
from kosmosx_torch.nn.xpos import apply_xpos
from kosmosx_torch.ops.decode_attention import decode_attention
from kosmosx_torch.ops.flash_attention import flash_attention
from kosmosx_torch.parallel import tensor as tpar
from kosmosx_torch.utils.quantize import _div127

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


def _quantize_kv(x: torch.Tensor):
    """(B, H, L, hd) -> (int8 codes, (B, H, L, 1) fp32 scales): symmetric
    absmax/127 per position and head, scale 1 where a row is all zero,
    rounding half to even (kosmosx_tpu/nn/attention.py:74-82), dividing
    exactly on the card too (``utils.quantize._div127``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, _div127(amax), 1.0)
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def plain_attention(q, k, v, *, causal: bool,
                    kv_len: Optional[torch.Tensor] = None,
                    segment_q: Optional[torch.Tensor] = None,
                    segment_kv: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    shared_k: Optional[torch.Tensor] = None,
                    shared_v: Optional[torch.Tensor] = None,
                    shared_on: Optional[torch.Tensor] = None,
                    attn_dropout: float = 0.0, rng=None) -> torch.Tensor:
    """(B,H,Lq,hd) attention with an fp32 softmax
    (``_jnp_attention``, kosmosx_tpu/nn/attention.py:85-161); with a key
    ``rng`` and ``attn_dropout > 0`` dropout on the probabilities.
    ``kv_len`` (B,) masks cache positions at or past it;
    ``q_offset`` (B,) is the absolute position of q[:, :, 0] for the causal
    mask against a cache. A fully masked row is a uniform softmax (mask
    value ``finfo.min``), as in JAX.

    ``k_scale``/``v_scale`` (B, H, Lk, 1): k and v are int8 codes, cast to
    q's dtype; the k scales multiply the fp32 scores, the v scales the
    probabilities before their cast. ``shared_k``/``shared_v`` (1, H, P,
    hd): a prefix every row sees before its own cache (masked per row by
    ``shared_on`` (B,)), under one softmax over the concatenated
    ``[shared | own]`` scores."""
    lq, lk = q.shape[-2], k.shape[-2]
    dev = q.device
    neg = torch.finfo(torch.float32).min
    s = q.float() @ k.float().transpose(-1, -2)  # int8 codes convert exactly
    if k_scale is not None:
        s = s * k_scale.transpose(-1, -2)
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
        s = torch.where(mask, s, neg)
    if shared_k is not None:
        ss = q.float() @ shared_k.float().transpose(-1, -2)
        if shared_on is not None:
            ss = torch.where(shared_on[:, None, None, None], ss, neg)
        s = torch.cat([ss, s], dim=-1)
    p = layers.dropout(torch.softmax(s, dim=-1), attn_dropout, rng)
    o_shared = None
    if shared_k is not None:
        ps, p = p[..., :shared_k.shape[-2]], p[..., shared_k.shape[-2]:]
        o_shared = ps.to(shared_v.dtype) @ shared_v
    if v_scale is not None:
        o = (p * v_scale.transpose(-1, -2)).to(q.dtype) @ v.to(q.dtype)
    else:
        o = p.to(v.dtype) @ v
    return o if o_shared is None else o + o_shared.to(o.dtype)


def _gathered_sp_attention(q, k, v, group, *, shard: int, n_shards: int,
                           zigzag: bool, causal: bool, segment_ids,
                           attn_dropout: float, rng):
    """Sequence-parallel attention over all-gathered K/V, the path of
    attention dropout (kosmosx_tpu/nn/attention.py:160-193). q, k, v are
    this rank's shards (B, H, Ll, hd), rotated already with their global
    positions, so gathering k is sound; the causal mask compares global
    positions (contiguous shards or the zigzag chunk order). The gather is
    differentiable (``comm.AllGather``). O(L) memory a rank."""
    from kosmosx_torch.parallel.comm import AllGather, all_gather
    from kosmosx_torch.parallel.ring_attention import zigzag_position_offsets

    ll = q.shape[2]
    local = torch.arange(ll, device=q.device)
    if zigzag:
        q_pos = zigzag_position_offsets(shard, ll, n_shards, q.device) + local
    else:
        q_pos = shard * ll + local
    k_pos = all_gather(q_pos, group)
    k_g = AllGather.apply(k.contiguous(), group, 2)
    v_g = AllGather.apply(v.contiguous(), group, 2)
    s = q.float() @ k_g.float().transpose(-1, -2)
    mask = None
    if causal:
        mask = (k_pos[None, None, None, :] <= q_pos[None, None, :, None])
    if segment_ids is not None:
        seg_kv = all_gather(segment_ids, group, dim=1)
        seg = segment_ids[:, None, :, None] == seg_kv[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = layers.dropout(torch.softmax(s, dim=-1), attn_dropout, rng)
    return p.to(v_g.dtype) @ v_g


def _sequence_parallel(q, k, v, group, *, schedule: str, causal: bool,
                       xpos: bool, xpos_scale_base: int, segment_ids,
                       attn_dropout: float, rng) -> torch.Tensor:
    """Attention over a sequence sharded across ``group``
    (kosmosx_tpu/nn/attention.py:264-310): q and k rotated with their
    global offsets (a contiguous shard at ``shard * l``, a zigzag shard's
    halves at ``shard * c`` and ``(2S - 1 - shard) * c``), the decay centred
    at ``(l * S) // 2``; then the ring, the zigzag ring or, under attention
    dropout, the gathered path."""
    from kosmosx_torch.parallel.comm import group_rank, group_size
    from kosmosx_torch.parallel.ring_attention import (
        ring_flash_attention, zigzag_ring_flash_attention)

    n_shards, shard = group_size(group), group_rank(group)
    l = q.shape[2]
    zigzag = schedule == "zigzag"
    center = (l * n_shards) // 2  # cancels in q.k; keeps fp ranges sane

    def rotate(t, downscale):
        if not xpos:
            return t
        kw = dict(scale_base=xpos_scale_base, downscale=downscale,
                  center=center)
        if zigzag:
            c = l // 2
            return torch.cat([
                apply_xpos(t[:, :, :c], offset=shard * c, **kw),
                apply_xpos(t[:, :, c:],
                           offset=(2 * n_shards - 1 - shard) * c, **kw)],
                dim=2)
        return apply_xpos(t, offset=shard * l, **kw)

    q = rotate(q, False)
    k = rotate(k, True)
    if rng is not None and attn_dropout > 0.0:
        return _gathered_sp_attention(
            q, k, v, group, shard=shard, n_shards=n_shards, zigzag=zigzag,
            causal=causal, segment_ids=segment_ids, attn_dropout=attn_dropout,
            rng=layers.fold_in(rng, shard))
    if zigzag:
        return zigzag_ring_flash_attention(
            q, k, v, group, q_segment_ids=segment_ids,
            kv_segment_ids=segment_ids)
    return ring_flash_attention(q, k, v, group, causal=causal,
                                q_segment_ids=segment_ids,
                                kv_segment_ids=segment_ids)


def _write_cache(cache: Dict[str, torch.Tensor], k, v, pos) -> None:
    """Write k, v (B, H, L, hd) at the slots ``pos`` (B, L) of ``cache`` in
    place, quantized where the cache holds int8 codes. The advanced indices
    (B, L) around the head slice put (B, L) first: the value is laid out
    (B, L, H, hd)."""
    b_idx = torch.arange(k.shape[0], device=k.device)[:, None]
    if "k_scale" in cache:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        cache["k_scale"][b_idx, :, pos, :] = ks.transpose(1, 2)
        cache["v_scale"][b_idx, :, pos, :] = vs.transpose(1, 2)
    cache["k"][b_idx, :, pos, :] = k.transpose(1, 2).to(cache["k"].dtype)
    cache["v"][b_idx, :, pos, :] = v.transpose(1, 2).to(cache["v"].dtype)


def self_attention(params, x: torch.Tensor, *, heads: int, subln: bool = True,
                   multiway: bool = False, split: Optional[int] = None,
                   causal: bool = True, xpos: bool = True,
                   xpos_scale_base: int = 512, use_flash: bool = True,
                   segment_ids: Optional[torch.Tensor] = None,
                   attn_dropout: float = 0.0, rng: Optional[int] = None,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index=None, prefill: bool = False,
                   shared_kv: Optional[Dict[str, torch.Tensor]] = None,
                   shared_on: Optional[torch.Tensor] = None,
                   pos_offset: Optional[torch.Tensor] = None,
                   kv_window: int = 0, kv_sink: int = 4,
                   decode_attn_kernel: bool = False,
                   xpos_center: Optional[torch.Tensor] = None, dtype=None,
                   sequence_axis: Optional[str] = None,
                   sequence_schedule: str = "ring",
                   sequence_group=None, tensor=None) -> torch.Tensor:
    """Self-attention over ``x`` (B, L, D) -> (B, L, D).

    KV cache: ``cache = {"k", "v"}`` of shape (B, H, Lmax, hd), or
    ``{"k", "k_scale", "v", "v_scale"}`` with int8 codes and (B, H, Lmax, 1)
    fp32 scales, and ``cache_index`` (B,) or scalar, the number of tokens
    already cached. The new keys and values are written into ``cache`` in
    place at ``cache_index`` (a one-token step with ``kv_window > 0`` at its
    ring slot); attention then covers the valid part of the cache. The
    prefill contract is the JAX one: it writes at index 0.

    ``shared_kv = {"k", "v"}`` (1, H, P, hd): a prefix at positions [0, P)
    that rows flagged in ``shared_on`` attend without a copy; ``pos_offset``
    (B,) shifts their xPos positions by P while the cache writes stay local.
    ``xpos_center`` (B,): the decay center of a re-centered cache
    (``nn/decoder.recenter_caches``).

    ``sequence_axis`` (without a cache): ``x`` is this rank's shard of a
    sequence split over the process group ``sequence_group`` (the mesh dim
    that name labels), laid out as ``sequence_schedule`` (``"ring"``:
    contiguous shards, ``"zigzag"``: ``parallel.ring_attention``'s
    layout).

    ``tensor`` (a ``parallel.tensor.Axis``): the parameters are this
    rank's cut of a tensor-parallel layer (``parallel/tensor.py``): q, k
    and v column-parallel over the rank's ``heads`` heads (the caller
    passes the rank's count, and a cache holds those heads), ``inner_ln``
    a distributed LayerNorm, the out-projection row-parallel; attention
    dropout folds the rank into its key (each rank drops its own heads)."""
    sp = cache is None and sequence_axis is not None
    if sp and tensor is not None:
        raise ValueError("sequence parallelism over a tensor mesh is not "
                         "supported: give the mesh one of the two")
    if sp and sequence_group is None:
        raise ValueError(f"sequence_axis={sequence_axis!r} needs its process "
                         f"group (sequence_group); parallel.seq_parallel's "
                         f"step passes it")
    b, l, d = x.shape

    def proj(p, t, fn=layers.linear):
        return multiway_apply(multiway,
                              lambda pp, xx: fn(pp, xx, dtype=dtype),
                              p, t, split)

    col = layers.linear
    if tensor is not None:
        x = tpar.copy_to(x, tensor)
        col = lambda pp, xx, dtype: tpar.column_linear(  # noqa: E731
            pp, xx, tensor, dtype=dtype)
        rng = layers.fold_in(rng, tensor.rank)
    q = proj(params["q"], x, col)
    q = _split_heads(q * (q.shape[-1] // heads) ** -0.5, heads)
    k = _split_heads(proj(params["k"], x, col), heads)
    v = _split_heads(proj(params["v"], x, col), heads)

    if sp:
        o = _sequence_parallel(
            q, k, v, sequence_group, schedule=sequence_schedule, causal=causal,
            xpos=xpos, xpos_scale_base=xpos_scale_base,
            segment_ids=segment_ids, attn_dropout=attn_dropout, rng=rng)
    elif cache is None:
        # the flash kernels have no dropout: attention dropout takes the
        # plain path, as in JAX (:314-315)
        if use_flash and l >= _FLASH_MIN_LEN and not (
                rng is not None and attn_dropout > 0.0):
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
                                segment_kv=segment_ids,
                                attn_dropout=attn_dropout, rng=rng)
    else:
        idx = torch.as_tensor(cache_index, device=x.device).long()
        if idx.ndim == 0:
            idx = idx.expand(b)
        if xpos:
            # absolute positions (plus a shared prefix's length); the center
            # stays fixed so cached keys stay valid, unless re-centered
            rot = idx if pos_offset is None else idx + pos_offset
            center = 0 if xpos_center is None else xpos_center
            q = apply_xpos(q, offset=rot, scale_base=xpos_scale_base,
                           center=center)
            k = apply_xpos(k, offset=rot, scale_base=xpos_scale_base,
                           downscale=True, center=center)
        if segment_ids is not None:
            # padded chunk positions are written as zeros
            valid = (segment_ids >= 0).to(k.dtype)[:, None, :, None]
            k = k * valid
            v = v * valid
        if kv_window > 0 and l == 1:
            # rolling cache: the first kv_sink slots are pinned, the rest a
            # ring; every slot holds a position older than the query, so
            # the kv_len mask alone is causal
            w, sink = kv_window, kv_sink
            pos = torch.where(idx < w, idx, sink + (idx - sink) % (w - sink))
            pos = pos[:, None]
            kv_len = torch.clamp_max(idx + 1, w)
            q_off = None
        else:
            pos = idx[:, None] + torch.arange(l, device=x.device)[None, :]
            kv_len = idx + l
            q_off = idx
        _write_cache(cache, k, v, pos)
        if prefill and use_flash and l >= _FLASH_MIN_LEN and shared_kv is None:
            # attention over the cache == causal attention over the chunk
            o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True, sm_scale=1.0,
                                q_segment_ids=segment_ids,
                                kv_segment_ids=segment_ids)
        elif decode_attn_kernel and l == 1 and shared_kv is None:
            # the causal mask is the kv_len mask at one query per row. The
            # JAX rule's cache shape conditions (:414-416) are limits of the
            # Pallas kernel; the CUDA kernel takes any cache length.
            o = decode_attention(q.contiguous(), cache["k"], cache["v"], kv_len,
                                 k_scale=cache.get("k_scale"),
                                 v_scale=cache.get("v_scale"))
        else:
            o = plain_attention(
                q, cache["k"], cache["v"], causal=causal, kv_len=kv_len,
                q_offset=q_off, k_scale=cache.get("k_scale"),
                v_scale=cache.get("v_scale"),
                shared_k=(None if shared_kv is None
                          else shared_kv["k"].to(q.dtype)),
                shared_v=None if shared_kv is None else shared_kv["v"],
                shared_on=shared_on)
    o = _merge_heads(o.to(x.dtype))
    if tensor is not None:
        if subln and "inner_ln" in params:
            o = multiway_apply(
                multiway, lambda pp, xx: tpar.layer_norm(
                    pp, xx, tensor, sliced=False), params["inner_ln"], o, split)
        return proj(params["out"], o, lambda pp, xx, dtype: tpar.row_linear(
            pp, xx, tensor, dtype=dtype))
    if subln and "inner_ln" in params:
        o = multiway_apply(multiway, layers.layer_norm, params["inner_ln"], o,
                           split)
    return proj(params["out"], o)
