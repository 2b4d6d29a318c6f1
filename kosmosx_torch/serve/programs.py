"""The serving engine's device programs (counterpart of
kosmosx_tpu/serve/programs.py).

Plain functions on tensors over the decoder's ``run_layers``, the
sampler's ``_prefill``/``sample_logits``/``token_logprob`` and
``recenter_caches``. The pool is the per-layer list of ``{"k", "v"[,
"k_scale", "v_scale"]}`` tensors of (max_batch, H, S, hd); every program
writes into the tensors that list holds, in place (JAX donates the pool to
the same end), and never copies the pool. Sampling draws from one
``torch.Generator`` on the engine's device in place of JAX's per-step
``fold_in`` keys.

JAX drops cache writes past the cache's end. The port's writes index and
would raise there, so each program keeps its writes in range: whole-prompt
prefills run the padded width cut to the cache length (only pads lie past
it: ``submit`` keeps every real token inside), the chunked ingestion runs on
copies of the ingesting rows with ``prefill_chunk`` spare positions, and a
speculative round writes an inactive slot's junk rows below the cache's end.
"""

from __future__ import annotations

from typing import List

import torch

from kosmosx_torch.core.config import KosmosConfig, MagnetoConfig
from kosmosx_torch.generate.sampler import (SamplingConfig, _decode_logits,
                                            _prefill, sample_logits,
                                            token_logprob)
from kosmosx_torch.generate.speculative import spec_round
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers


def _embed(params, cfg: MagnetoConfig, tokens, double_scale: bool, offset=0):
    """Token embedding plus positions; ``double_scale`` applies embed_scale
    twice, as a parity-mode Kosmos forward does."""
    if double_scale:
        emb = dec.embed_only(params, cfg, tokens)
        return dec.forward_embedding(params, cfg, token_embedding=emb,
                                     offset=offset)[0]
    return dec.forward_embedding(params, cfg, tokens, offset=offset)[0]


def _prefill_one(params, prompt, length, generator, cfg: MagnetoConfig,
                 scfg: SamplingConfig, max_len: int,
                 double_scale: bool = False, rows=None):
    """prompt (A, P) -> (first tokens (A,), their log-probs (A,), batch-A
    caches of ``max_len`` positions) (kosmosx_tpu/serve/programs.py:24-55).

    Admission runs it at A = 1 and, for a full group of simple text-only
    admissions, at the engine's one batched-admission size
    (``ServeEngine._admit_bucket``); smaller groups admit one by one. At
    256 positions or more the prefill runs the flash kernel."""
    prompt = prompt[:, :max_len]
    caches = dec.init_cache(cfg, prompt.shape[0], max_len, device=prompt.device,
                            params=params)
    x = _embed(params, cfg, prompt, double_scale)
    last_logits = _prefill(params, cfg, x, caches, length)
    first = sample_logits(last_logits, scfg, generator, rows=rows)
    return first, token_logprob(last_logits, first), caches


def _prefill_mm_one(model, prompt, images, length, generator,
                    kcfg: KosmosConfig, scfg: SamplingConfig, max_len: int,
                    rows=None):
    """Multimodal admission at batch 1: encode the image(s), splice them in,
    prefill (kosmosx_tpu/serve/programs.py:58-89). Returns (first token
    (1,), its log-prob, caches, the spliced length (1,))."""
    dcfg = kcfg.decoder
    x, num_images = model.embed_prompt(prompt, images)
    full_length = length + num_images * kcfg.image_embed_len
    x = x[:, :max_len]
    caches = dec.init_cache(dcfg, 1, max_len, device=prompt.device,
                            params=model)
    last_logits = _prefill(model["decoder"], dcfg, x, caches, full_length)
    first = sample_logits(last_logits, scfg, generator, rows=rows)
    return first, token_logprob(last_logits, first), caches, full_length


def _prefill_mm_prefix(model, prefix, images, kcfg: KosmosConfig,
                       max_len: int):
    """Chunked multimodal admission, step 1 of 2: the vision tower once and
    a prefill of the spliced prefix only, ``splice_index`` text tokens and
    the image embeddings (kosmosx_tpu/serve/programs.py:92-129); the text
    remainder then streams through ``_prefill_chunk_pool``. Returns
    (batch-1 caches, the cached length)."""
    dcfg = kcfg.decoder
    img = model.encode_images(images)                # (1, [M,] K, D)
    if img.ndim == 4:
        img = img.reshape(1, -1, img.shape[-1])
    text_emb = dec.embed_only(model["decoder"], dcfg, prefix)
    spliced = torch.cat([text_emb, img.to(text_emb.dtype)], dim=1)
    if kcfg.parity_double_scale:
        x, _ = dec.forward_embedding(model["decoder"], dcfg,
                                     token_embedding=spliced)
    else:
        x = spliced + layers.positional_embedding(
            model["decoder"]["pos"], spliced.shape[1],
            padding_idx=dcfg.padding_idx, dtype=dcfg.dtype)
    lp = spliced.shape[1]
    length = torch.full((1,), lp, dtype=torch.long, device=prefix.device)
    caches = dec.init_cache(dcfg, 1, max_len, device=prefix.device,
                            params=model)
    _prefill(model["decoder"], dcfg, x, caches, length)
    return caches, lp


def _prefill_suffix(params, suffix, length, start, caches_one, generator,
                    cfg: MagnetoConfig, scfg: SamplingConfig,
                    double_scale: bool = False, shared=None, rows=None):
    """Continue a batch-1 prefill (kosmosx_tpu/serve/programs.py:132-191):
    ingest ``suffix`` (1, K; pads past ``length``) into ``caches_one`` at
    cache position ``start`` (a Python int), in place. This is the
    prefix-hit admission: ``caches_one`` is the slot's own row of the pool,
    into which the registered prefix was copied (copy mode), or a fresh
    batch-1 cache (share mode, where the prefix lives in the broadcast
    ``shared`` segment and positions shift by its length).

    It runs without ``prefill``: a copy-mode write starts past 0 and a
    share-mode one attends the segment too, so attention runs over the
    cache (plain attention), never the prefill's flash branch, which holds
    only for a write at index 0 with nothing before it. Returns (first
    token (1,), its log-prob)."""
    shared_caches, shared_on, pos_offset = shared or (None, None, None)
    k = suffix.shape[1]
    dev = suffix.device
    seg = torch.where(torch.arange(k, device=dev)[None, :] < length[:, None],
                      0, -1).to(torch.int32)
    index = torch.full((1,), start, dtype=torch.long, device=dev)
    pos = index if pos_offset is None else index + pos_offset
    x = _embed(params, cfg, suffix, double_scale, offset=pos[:, None])
    h = dec.run_layers(params, x, cfg, caches=caches_one, cache_index=index,
                       segment_ids=seg, shared_caches=shared_caches,
                       shared_on=shared_on, pos_offset=pos_offset)
    hb = h[torch.arange(1, device=dev), length - 1][:, None]
    blog = dec.output_logits(params, hb, cfg)[:, 0].float()
    first = sample_logits(blog, scfg, generator, rows=rows)
    return first, token_logprob(blog, first)


def _trim_shared(caches_one, length: int, dtype) -> List[dict]:
    """Batch-1 caches -> the read-only shared segment: the first ``length``
    positions, int8 codes dequantized (kosmosx_tpu/serve/programs.py:
    194-212)."""
    out = []
    for c in caches_one:
        if "k_scale" in c:
            k = (c["k"].float() * c["k_scale"]).to(dtype)
            v = (c["v"].float() * c["v_scale"]).to(dtype)
        else:
            k, v = c["k"], c["v"]
        out.append({"k": k[..., :length, :].clone(),
                    "v": v[..., :length, :].clone()})
    return out


def _slot_view(caches, slot: int) -> List[dict]:
    """Batch-1 views of pool row ``slot``: writes through them land in the
    pool."""
    return [{k: t[slot:slot + 1] for k, t in c.items()} for c in caches]


def _insert_slot(caches, caches_one, slot: int) -> None:
    """Write a batch-1 cache into pool row ``slot``, in place
    (kosmosx_tpu/serve/programs.py:215-236)."""
    for pool, one in zip(caches, caches_one):
        for k, t in pool.items():
            t[slot].copy_(one[k][0])


def _insert_rows(caches, caches_many, slots: torch.Tensor) -> None:
    """Scatter a batch-A cache's rows into pool rows ``slots`` (A,), in place
    (kosmosx_tpu/serve/programs.py:239-257)."""
    for pool, many in zip(caches, caches_many):
        for k, t in pool.items():
            t[slots] = many[k]


def _recenter_pool(caches, delta, cfg: MagnetoConfig) -> None:
    """Slide each slot's xPos decay center forward by ``delta`` (B,)
    positions, in place (``recenter_caches`` computes new keys; they are
    copied into the tensors the pool holds). Rows at delta 0 are unchanged:
    keys times 1.0, and int8 keys re-quantize to the same codes
    (kosmosx_tpu/serve/programs.py:260-267)."""
    for pool, new in zip(caches, dec.recenter_caches(caches, delta, cfg)):
        for k, t in pool.items():
            if new[k] is not t:
                t.copy_(new[k])


def _decode_core(params, last_tokens, caches, index, active, generator,
                 cfg: MagnetoConfig, scfg: SamplingConfig, pad_id: int = 1,
                 double_scale: bool = False, shared=None, rows=None,
                 center=None):
    """One decode step for every slot (kosmosx_tpu/serve/programs.py:
    270-319). Inactive slots compute on the pad feed, but their index does
    not advance and their token is ignored. Returns (next tokens (B,), their
    log-probs, the new index)."""
    last_tokens = torch.where(active, last_tokens, pad_id)
    logits = _decode_logits(params, cfg, last_tokens[:, None], caches, index,
                            double_scale=double_scale, shared=shared,
                            xpos_center=center)[:, 0]
    nxt = sample_logits(logits, scfg, generator, rows=rows)
    return nxt, token_logprob(logits, nxt), index + active.to(index.dtype)


def _decode_block(params, last_tokens, caches, index, active, generator,
                  cfg: MagnetoConfig, scfg: SamplingConfig, block: int,
                  pad_id: int = 1, double_scale: bool = False, shared=None,
                  rows=None, center=None):
    """``block`` decode steps for every slot, the token fed back on the
    device with no host read between them (kosmosx_tpu/serve/programs.py:
    338-370). Returns (tokens (B, block), log-probs (B, block), the last
    token, the new index); ``center`` stays fixed within the block."""
    toks, lps = [], []
    for _ in range(block):
        last_tokens, lp, index = _decode_core(
            params, last_tokens, caches, index, active, generator, cfg, scfg,
            pad_id, double_scale, shared, rows, center)
        toks.append(last_tokens)
        lps.append(lp)
    return torch.stack(toks, 1), torch.stack(lps, 1), last_tokens, index


def _spec_core(params, dparams, last_tokens, caches, dcaches, index, index_d,
               active, generator, cfg: MagnetoConfig, dcfg: MagnetoConfig,
               scfg: SamplingConfig, gamma: int, pad_id: int = 1,
               double_scale: bool = False, shared_t=None, shared_d=None):
    """One speculative round for every slot (kosmosx_tpu/serve/programs.py:
    373-394). Inactive slots compute on the pad feed; their index does not
    advance and their tokens are ignored. An inactive slot's index may sit
    within gamma of the cache's end (its request overran its budget there),
    so its round writes at most ``S - gamma - 1``: junk rows of a slot that
    admission overwrites whole. Returns (emit (B, gamma+1), log-probs,
    n_emit (B,), carry, index, index_d)."""
    last_tokens = torch.where(active, last_tokens, pad_id)
    top = caches[0]["k"].shape[2] - gamma - 1
    emit, emit_lp, n_acc, carry_next = spec_round(
        params, dparams, cfg, dcfg, scfg, gamma, last_tokens,
        torch.where(active, index, index.clamp_max(top)), caches, dcaches,
        generator, double_scale_t=double_scale,
        index_d=torch.where(active, index_d, index_d.clamp_max(top)),
        shared_t=shared_t, shared_d=shared_d)
    n_emit = torch.where(active, n_acc + 1, 0)
    return (emit, emit_lp, n_emit, carry_next, index + n_emit,
            index_d + n_emit)


def _spec_block_pool(params, dparams, last_tokens, caches, dcaches, index,
                     index_d, active, generator, cfg: MagnetoConfig,
                     dcfg: MagnetoConfig, scfg: SamplingConfig, gamma: int,
                     block: int, pad_id: int = 1, double_scale: bool = False,
                     shared_t=None, shared_d=None):
    """``block`` speculative rounds (kosmosx_tpu/serve/programs.py:405-438).
    Returns emits (block, B, gamma+1), their log-probs, n_emits (block, B),
    the carry, index and index_d."""
    emits, lps, ns = [], [], []
    for _ in range(block):
        emit, lp, n, last_tokens, index, index_d = _spec_core(
            params, dparams, last_tokens, caches, dcaches, index, index_d,
            active, generator, cfg, dcfg, scfg, gamma, pad_id, double_scale,
            shared_t, shared_d)
        emits.append(emit)
        lps.append(lp)
        ns.append(n)
    return (torch.stack(emits), torch.stack(lps), torch.stack(ns),
            last_tokens, index, index_d)


def _gather_rows(caches, slots: torch.Tensor, spare: int) -> List[dict]:
    """Copies of pool rows ``slots`` with ``spare`` more positions (zeros;
    ones for int8 scales, as ``init_cache`` makes them)."""
    out = []
    for c in caches:
        row = {}
        for k, t in c.items():
            sub = t.index_select(0, slots)
            pad = sub.new_ones if k.endswith("_scale") else sub.new_zeros
            row[k] = torch.cat([sub, pad(sub.shape[:2] + (spare,)
                                         + sub.shape[3:])], dim=2)
        out.append(row)
    return out


def _scatter_rows(caches, rows: List[dict], slots: torch.Tensor) -> None:
    for c, r in zip(caches, rows):
        for k, t in c.items():
            t[slots] = r[k][:, :, :t.shape[2]]


def _prefill_chunk_pool(params, tokens, seg, caches, index, slots, boundary,
                        generator, cfg: MagnetoConfig, scfg: SamplingConfig,
                        double_scale: bool = False, shared=None, rows=None):
    """Ingest one prompt chunk for the ingesting slots
    (kosmosx_tpu/serve/programs.py:441-482). ``slots`` (A,) are those
    slots; tokens and seg (A, K) their next K prompt tokens (seg 0) and pads
    (seg -1); ``boundary`` (A,) the position of each row's last real token.
    ``params``, ``shared`` and ``rows`` are already cut to those rows. JAX
    runs the chunk over every slot with zero valid tokens elsewhere; here
    the other rows are left out, so a decoding slot's cache is not touched
    at all, and the ingesting rows run on copies with K spare positions for
    a last chunk's pads. Returns (the sampled boundary token (A,), its
    log-prob, the index advanced by each row's real tokens (B,))."""
    k = tokens.shape[1]
    sub = _gather_rows(caches, slots, k)
    idx = index.index_select(0, slots)
    shared_caches, shared_on, pos_offset = shared or (None, None, None)
    pos = idx if pos_offset is None else idx + pos_offset
    x = _embed(params, cfg, tokens, double_scale, offset=pos[:, None])
    h = dec.run_layers(params, x, cfg, caches=sub, cache_index=idx,
                       segment_ids=seg, shared_caches=shared_caches,
                       shared_on=shared_on, pos_offset=pos_offset)
    _scatter_rows(caches, sub, slots)
    hb = h[torch.arange(h.shape[0], device=h.device), boundary][:, None]
    blog = dec.output_logits(params, hb, cfg)[:, 0].float()
    first = sample_logits(blog, scfg, generator, rows=rows)
    index = index.clone()
    index[slots] = idx + (seg >= 0).sum(dim=1).to(index.dtype)
    return first, token_logprob(blog, first), index
