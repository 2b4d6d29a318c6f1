"""Magneto (sub-LN) decoder stack (counterpart of kosmosx_tpu/nn/decoder.py).

Pre-LN layers ``x += Attn(LN(x)); x += FFN(LN(x))`` with sub-LN inside both,
the Magneto gain on fc1/fc2/out/v, the FFN activation in fp32, a final
LayerNorm and an untied output projection; multiway duplicates every
projection and LayerNorm of a layer into two experts.

The layer stack is a Python loop over per-layer parameter modules. The KV
cache is a list with one ``{"k", "v"}`` dict of (B, H, Lmax, hd) tensors per
layer (``{"k", "k_scale", "v", "v_scale"}`` with int8 codes and fp32 scales
under ``kv_cache_dtype="int8"``), updated in place by each layer. That list
already is the layout the JAX package builds with ``unstack_caches`` for
its unrolled decode (kosmosx_tpu/nn/decoder.py:517-550), so neither that
nor ``lax.scan`` has a counterpart here.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import MagnetoConfig
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.attention import (_quantize_kv, init_self_attention,
                                        self_attention)
from kosmosx_torch.nn.moe import init_moe_ffn, moe_ffn
from kosmosx_torch.nn.multiway import init_multiway, multiway_apply
from kosmosx_torch.nn.xpos import recenter_scale
from kosmosx_torch.ops import quant_matmul  # noqa: F401  (registers the W8 op)
from kosmosx_torch.parallel import tensor as tpar


# the matmuls a "dots" remat saves (jax.checkpoint_policies.dots_saveable),
# and those without batch dims that "dots_no_batch" saves
# (dots_with_no_batch_dims_saveable): the projections, which ``matmul``
# folds into ``mm``/``addmm``, and the W8 product (``x @ q`` in JAX), and
# not attention's batched products nor the MoE experts' (``bmm`` over E)
_NO_BATCH_DOTS = frozenset((torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default,
                            torch.ops.kosmosx_torch.w8_matmul.default))
_DOTS = _NO_BATCH_DOTS | {torch.ops.aten.bmm.default,
                          torch.ops.aten.baddbmm.default}


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else \
            CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


_REMAT_CONTEXTS = {
    "nothing": torch.utils.checkpoint.noop_context_fn,
    "dots": _saving(_DOTS),
    "dots_no_batch": _saving(_NO_BATCH_DOTS),
}


def init_ffn(gen, embed_dim: int, ffn_dim: int, *, subln: bool = True,
             device=None):
    params = {"fc1": layers.init_linear(gen, embed_dim, ffn_dim, device=device),
              "fc2": layers.init_linear(gen, ffn_dim, embed_dim, device=device)}
    if subln:
        params["ffn_ln"] = layers.init_layer_norm(ffn_dim, device=device)
    return params


def ffn(params, x: torch.Tensor, *, activation: str = "gelu",
        dropout_rate: float = 0.0, activation_dropout: float = 0.0, rng=None,
        dtype=None, activation_fp32: bool = True,
        tensor=None) -> torch.Tensor:
    """kosmosx_tpu/nn/decoder.py:62-79; the activation runs in fp32 as
    torchscale's ``activation_fn(x.float())``. ``tensor`` (a
    ``parallel.tensor.Axis``): the parameters are this rank's cut, fc1
    column-parallel, ``ffn_ln`` a distributed LayerNorm, fc2 row-parallel;
    the activation dropout folds the rank into its key."""
    act = layers.activation_fn(activation)
    if tensor is not None:
        x = tpar.copy_to(x, tensor)
        h = tpar.column_linear(params["fc1"], x, tensor, dtype=dtype)
    else:
        h = layers.linear(params["fc1"], x, dtype=dtype)
    h = act(h.float()).to(h.dtype) if activation_fp32 else act(h)
    key = layers.fold_in(rng, 0)
    if tensor is not None:
        key = layers.fold_in(key, tensor.rank)
    h = layers.dropout(h, activation_dropout, key)
    if tensor is not None:
        if "ffn_ln" in params:
            h = tpar.layer_norm(params["ffn_ln"], h, tensor, sliced=True)
        h = tpar.row_linear(params["fc2"], h, tensor, dtype=dtype)
    else:
        if "ffn_ln" in params:
            h = layers.layer_norm(params["ffn_ln"], h)
        h = layers.linear(params["fc2"], h, dtype=dtype)
    return layers.dropout(h, dropout_rate, layers.fold_in(rng, 1))


def init_decoder_layer(gen, cfg: MagnetoConfig, device=None):
    """kosmosx_tpu/nn/decoder.py:86-106, Magneto gain applied in place. With
    ``moe_experts > 0`` the FFN is the MoE FFN, which replaces the multiway
    pair (kosmosx_tpu/nn/decoder.py:93-98), and the gain scales its stacked
    expert fc1/fc2 (:124-127)."""

    def ln(g):
        return layers.init_layer_norm(cfg.embed_dim, device=device)

    params = {
        "attn": init_self_attention(gen, cfg.embed_dim, cfg.heads,
                                    subln=cfg.subln, multiway=cfg.multiway,
                                    device=device),
        "attn_ln": init_multiway(cfg.multiway, gen, ln),
        "ffn": init_moe_ffn(gen, cfg.embed_dim, cfg.ffn_dim, cfg.moe_experts,
                            subln=cfg.subln, device=device)
        if cfg.moe_experts > 0 else
        init_multiway(cfg.multiway, gen, lambda g: init_ffn(
            g, cfg.embed_dim, cfg.ffn_dim, subln=cfg.subln, device=device)),
        "final_ln": init_multiway(cfg.multiway, gen, ln),
    }
    if cfg.subln:
        gamma = init.magneto_gamma(cfg.layers)
        experts = (lambda p: [p["A"], p["B"]]) if cfg.multiway else \
            (lambda p: [p])
        for e in experts(params["attn"]["v"]) + experts(params["attn"]["out"]):
            e["w"].mul_(gamma)
        ffns = [params["ffn"]["experts"]] if cfg.moe_experts > 0 else \
            experts(params["ffn"])
        for e in ffns:
            e["fc1"]["w"].mul_(gamma)
            e["fc2"]["w"].mul_(gamma)
    return params


def decoder_layer(params, x: torch.Tensor, cfg: MagnetoConfig, *,
                  split: Optional[int] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  rng: Optional[int] = None,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_index=None, prefill: bool = False,
                  shared_kv: Optional[Dict[str, torch.Tensor]] = None,
                  shared_on: Optional[torch.Tensor] = None,
                  pos_offset: Optional[torch.Tensor] = None,
                  xpos_center: Optional[torch.Tensor] = None,
                  sequence_group=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-LN layer (kosmosx_tpu/nn/decoder.py:139-204) -> (x, aux), aux
    the layer's fp32 MoE routing loss (None for a dense FFN); ``cache`` is
    updated in place. ``rng``: the layer's dropout key, split three ways
    (attention, its residual, the FFN) as in JAX. Under an MoE FFN, pads
    (``segment_ids < 0``) route nowhere, and with a cache the routing drops
    no token (:178-193). With ``cfg.sequence_axis``, ``x`` is this rank's
    shard of the sequence over ``sequence_group``. A layer cut by
    ``parallel.tensor.shard_model`` runs over its ``tensor`` and
    ``expert`` axes (``heads / tp`` heads a rank, a cache of those); one
    marked by ``parallel.tensor.mark_batch`` gives its MoE routing loss as
    the rank's share of the global batch's."""
    dtype = cfg.dtype
    tp, ep = tpar.axes(params)
    keys = [layers.fold_in(rng, i) for i in range(3)]
    h = multiway_apply(cfg.multiway, layers.layer_norm, params["attn_ln"], x,
                       split)
    h = self_attention(
        params["attn"], h, heads=cfg.heads // (tp.size if tp else 1),
        subln=cfg.subln,
        multiway=cfg.multiway, split=split, causal=True,
        xpos=cfg.xpos_rel_pos, xpos_scale_base=cfg.xpos_scale_base,
        use_flash=cfg.use_flash_attention, segment_ids=segment_ids,
        attn_dropout=cfg.attention_dropout, rng=keys[0], cache=cache,
        cache_index=cache_index, prefill=prefill, shared_kv=shared_kv,
        shared_on=shared_on, pos_offset=pos_offset, kv_window=cfg.kv_window,
        kv_sink=cfg.kv_sink, decode_attn_kernel=cfg.decode_attn_kernel,
        xpos_center=xpos_center, dtype=dtype, sequence_axis=cfg.sequence_axis,
        sequence_schedule=cfg.sequence_schedule, sequence_group=sequence_group,
        tensor=tp)
    x = x + layers.dropout(h, cfg.dropout, keys[1])
    h = multiway_apply(cfg.multiway, layers.layer_norm, params["final_ln"], x,
                       split)
    if cfg.moe_experts > 0:
        h, aux = moe_ffn(
            params["ffn"], h, num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, activation=cfg.activation,
            activation_fp32=cfg.activation_fp32, dtype=dtype,
            aux_weight=cfg.moe_aux_weight, z_weight=cfg.moe_z_weight,
            rng=keys[2], dropout_rate=cfg.dropout,
            valid=None if segment_ids is None else segment_ids >= 0,
            no_drop=cache is not None, tensor=tp, expert=ep,
            batch_group=getattr(params, "batch_group", None))
        return x + h, aux
    h = multiway_apply(
        cfg.multiway,
        lambda p, xx: ffn(p, xx, activation=cfg.activation,
                          dropout_rate=cfg.dropout,
                          activation_dropout=cfg.activation_dropout,
                          rng=keys[2], dtype=dtype,
                          activation_fp32=cfg.activation_fp32, tensor=tp),
        params["ffn"], h, split)
    return x + h, None


def init_decoder(gen, cfg: MagnetoConfig, *, with_embeddings: bool = True,
                 device=None) -> Dict[str, Any]:
    """Decoder parameter tree with the JAX paths
    (kosmosx_tpu/nn/decoder.py:211-231), per-layer list layout."""
    cfg.check_supported()
    params: Dict[str, Any] = {}
    if with_embeddings:
        params["embed"] = layers.init_embedding(
            gen, cfg.vocab_size, cfg.embed_dim, padding_idx=cfg.padding_idx,
            device=device)
        params["pos"] = layers.init_positional_embedding(
            gen, cfg.max_positions, cfg.embed_dim, padding_idx=cfg.padding_idx,
            device=device)
        params["out_proj"] = {"w": init.magneto_output_projection(
            gen, (cfg.embed_dim, cfg.vocab_size), device)}
    params["layers"] = [init_decoder_layer(gen, cfg, device)
                        for _ in range(cfg.layers)]
    params["ln"] = init_multiway(
        cfg.multiway, gen,
        lambda g: layers.init_layer_norm(cfg.embed_dim, device=device))
    return params


def embed_only(params, cfg: MagnetoConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Position-free scaled token embedding (kosmosx_tpu/nn/decoder.py:234)."""
    return cfg.embed_scale * layers.embedding(params["embed"], tokens,
                                              dtype=cfg.dtype)


def forward_embedding(params, cfg: MagnetoConfig, tokens=None, *,
                      token_embedding=None, offset=0,
                      rng: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, embed)`` with ``embed = embed_scale * token_embedding`` and
    ``x = embed + positions``, then dropout under the key ``rng``
    (kosmosx_tpu/nn/decoder.py:242-267). Passing ``token_embedding``
    re-applies embed_scale: the double-scale quirk."""
    if token_embedding is None:
        token_embedding = layers.embedding(params["embed"], tokens,
                                           dtype=cfg.dtype)
    embed = cfg.embed_scale * token_embedding
    positions = layers.positional_embedding(
        params["pos"], token_embedding.shape[1], padding_idx=cfg.padding_idx,
        offset=offset, dtype=cfg.dtype)
    return layers.dropout(embed + positions, cfg.dropout, rng), embed


def _call_layer(lp, x, cfg, **kw):
    """``decoder_layer`` on ``lp``: through the module's ``__call__`` where
    ``lp`` is a module, directly for a plain dict tree."""
    if isinstance(lp, nn.Module):
        return lp(decoder_layer, x, cfg, **kw)
    return decoder_layer(lp, x, cfg, **kw)


def run_layers(params, x: torch.Tensor, cfg: MagnetoConfig, *,
               split: Optional[int] = None,
               segment_ids: Optional[torch.Tensor] = None,
               rng: Optional[int] = None,
               caches: Optional[List[Dict[str, torch.Tensor]]] = None,
               cache_index=None, prefill: bool = False,
               shared_caches: Optional[List[Dict[str, torch.Tensor]]] = None,
               shared_on: Optional[torch.Tensor] = None,
               pos_offset: Optional[torch.Tensor] = None,
               xpos_center: Optional[torch.Tensor] = None,
               with_aux: bool = False, sequence_group=None):
    """The layer stack and the final LayerNorm
    (kosmosx_tpu/nn/decoder.py:308-455) -> hidden, or (hidden, aux) with
    ``with_aux``: aux the layers' summed fp32 MoE routing loss (0 for a
    dense decoder), in JAX's order (:320-322); ``caches[i]`` is updated in place
    by layer i. ``shared_caches``: a read-only per-layer prefix (the
    ``caches`` layout at batch 1) that rows flagged in ``shared_on`` attend,
    ``pos_offset`` (B,) its length; ``xpos_center`` (B,) the decay center
    of re-centered caches.

    With ``cfg.remat`` and gradients enabled, each layer runs under
    non-reentrant activation checkpointing (the ``jax.checkpoint`` of
    :337-348): ``"nothing"`` saves only the layer's input and recomputes the
    rest in the backward; ``"dots"`` also saves every matmul output
    (``dots_saveable``), so the backward recomputes the elementwise work and
    the flash forward but no projection; ``"dots_no_batch"`` saves the
    projections (``mm``/``addmm``) and recomputes attention's batched
    products (``bmm``) too.

    The key ``rng`` gives layer i the dropout key ``fold_in(rng, i)``,
    derived before the checkpointed call: the layer's
    masks are functions of that integer, so its recomputation draws the
    forward's masks and the gradients equal those without remat. A
    checkpointed layer returns its aux beside its output.

    A layer that is a module runs through its ``__call__``
    (``ParamTree.forward``), so hooks on it run: FSDP2's all-gather of a
    layer sharded by ``parallel.sharding.shard_params``. ``sequence_group``:
    the process group of ``cfg.sequence_axis``."""
    cfg.check_supported()
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    aux = None
    for i, lp in enumerate(params["layers"]):
        kw = dict(split=split, segment_ids=segment_ids,
                  rng=layers.fold_in(rng, i),
                  cache=None if caches is None else caches[i],
                  cache_index=cache_index, prefill=prefill,
                  shared_kv=None if shared_caches is None else shared_caches[i],
                  shared_on=shared_on, pos_offset=pos_offset,
                  xpos_center=xpos_center, sequence_group=sequence_group)
        if remat:
            x, laux = checkpoint(
                _call_layer, lp, x, cfg, use_reentrant=False,
                context_fn=_REMAT_CONTEXTS[cfg.remat_policy], **kw)
        else:
            x, laux = _call_layer(lp, x, cfg, **kw)
        if laux is not None:
            aux = laux if aux is None else aux + laux
    h = multiway_apply(cfg.multiway, layers.layer_norm, params["ln"], x, split)
    if not with_aux:
        return h
    return h, aux if aux is not None else \
        torch.zeros((), dtype=torch.float32, device=h.device)


def output_logits(params, hidden: torch.Tensor,
                  cfg: MagnetoConfig) -> torch.Tensor:
    return layers.linear(params["out_proj"], hidden, dtype=cfg.dtype)


def decoder_forward(params, tokens: torch.Tensor, cfg: MagnetoConfig, *,
                    segment_ids: Optional[torch.Tensor] = None,
                    rng: Optional[int] = None,
                    position_offset=0, with_aux: bool = False,
                    sequence_group=None):
    """tokens (B, L) -> logits (B, L, vocab), or (logits, aux) with
    ``with_aux`` (kosmosx_tpu/nn/decoder.py:462-480); the key ``rng``
    splits into the embedding's dropout key and the layers', as JAX splits
    it. ``position_offset``: the global position of ``tokens[:, 0]`` (an
    int), or of every position less its index (an (L,) tensor: a zigzag
    shard's ``parallel.ring_attention.zigzag_position_offsets``), for a
    shard of a sequence split over ``sequence_group`` (the process group
    of ``cfg.sequence_axis``)."""
    x, _ = forward_embedding(params, cfg, tokens, rng=layers.fold_in(rng, 0),
                             offset=position_offset)
    out = run_layers(params, x, cfg, segment_ids=segment_ids,
                     rng=layers.fold_in(rng, 1), with_aux=with_aux,
                     sequence_group=sequence_group)
    if with_aux:
        return output_logits(params, out[0], cfg), out[1]
    return output_logits(params, out, cfg)


def init_cache(cfg: MagnetoConfig, batch: int, max_len: int, *, dtype=None,
               device=None, params=None) -> List[Dict[str, torch.Tensor]]:
    """Per-layer KV caches (kosmosx_tpu/nn/decoder.py:490-514, list
    layout): zeroed ``{"k", "v"}`` in ``dtype`` (default the compute
    dtype), or with ``cfg.kv_cache_dtype == "int8"`` zeroed int8 codes and
    fp32 scales of ones, ``{"k", "k_scale", "v", "v_scale"}``. ``params``:
    the decoder tree (or a model holding one) the caches serve; for one cut
    over a ``tensor`` mesh (``parallel.tensor.shard_model``) they hold its
    ``heads / tp`` heads."""
    tp, _ = tpar.axes(params)
    heads = cfg.heads // (tp.size if tp else 1)
    cfg.check_supported()
    shape = (batch, heads, max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.ones(sshape, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v_scale": torch.ones(sshape, device=device)}
                for _ in range(cfg.layers)]
    dtype = dtype or cfg.dtype
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.layers)]


def recenter_caches(caches: List[Dict[str, torch.Tensor]], delta,
                    cfg: MagnetoConfig) -> List[Dict[str, torch.Tensor]]:
    """New caches whose keys' xPos decay center sits ``delta`` (scalar or
    (B,)) positions further on: keys times ``zeta**(delta/scale_base)``
    (``nn/xpos.recenter_scale``); queries must then rotate with
    ``xpos_center`` moved by ``delta`` (kosmosx_tpu/nn/decoder.py:553-585).
    int8 keys are dequantised, rescaled and quantized again; values carry
    no xPos and are shared with ``caches``."""
    factor = recenter_scale(cfg.head_dim, delta, cfg.xpos_scale_base,
                            device=caches[0]["k"].device)

    def rescale(cache):
        if "k_scale" in cache:
            k, ks = _quantize_kv(cache["k"].float() * cache["k_scale"] * factor)
            return {**cache, "k": k, "k_scale": ks}
        return {**cache, "k": (cache["k"].float() * factor).to(cache["k"].dtype)}

    return [rescale(c) for c in caches]
