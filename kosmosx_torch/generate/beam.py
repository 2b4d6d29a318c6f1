"""Beam-search decoding over the KV cache
(counterpart of kosmosx_tpu/generate/beam.py).

One prefill at batch B, the caches repeated to B*K beams, then a Python
loop: each step scores the K·V candidates of every row, keeps the K best,
and gathers every layer's cache rows from the beams' parents. EOS
semantics are JAX's: a finished beam is frozen (its only continuation is
EOS at zero cost), and the final scores are normalised by the generated
length, ``score / len**length_penalty``, before the beams are sorted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kosmosx_torch.core.config import KosmosConfig, MagnetoConfig
from kosmosx_torch.generate.sampler import (_decode_logits, _lengths,
                                            _mm_max_len, _mm_prompt, _prefill)
from kosmosx_torch.nn import decoder as dec


def _gather_caches(caches, rows: torch.Tensor) -> None:
    """Every layer's cache rows ``rows`` (on dim 0 of the codes, values and
    int8 scales), assigned back into ``caches``: ``index_select`` makes new
    tensors, and attention writes into the ones the list holds."""
    for cache in caches:
        for key, t in cache.items():
            cache[key] = t.index_select(0, rows)


def _beam_from_logits(params, cfg: MagnetoConfig, last_logits, caches,
                      start_index, beam: int, new_tokens: int,
                      length_penalty: float, eos_id: Optional[int],
                      double_scale: bool):
    """Beam loop from a finished prefill: ``last_logits`` (B, V) at the
    prompt boundary, batch-B ``caches``, ``start_index`` (B,) the cached
    length of each row (kosmosx_tpu/generate/beam.py:47-124). Returns
    (tokens (B, K, T), normalised scores, raw log-probs, generated lengths
    (B, K)), beams sorted best first."""
    b = last_logits.shape[0]
    v = cfg.vocab_size
    dev = last_logits.device
    neg = torch.finfo(torch.float32).min
    _gather_caches(caches, torch.arange(b, device=dev).repeat_interleave(beam))

    logp0 = torch.log_softmax(last_logits.float(), dim=-1)
    scores, first = torch.topk(logp0, beam, dim=-1)          # (B, K)
    tokens = torch.full((b, beam, new_tokens), cfg.padding_idx,
                        dtype=torch.long, device=dev)
    tokens[:, :, 0] = first
    finished = (first == eos_id if eos_id is not None
                else torch.zeros_like(first, dtype=torch.bool))
    gen_len = torch.ones((b, beam), dtype=torch.long, device=dev)
    index = start_index.repeat_interleave(beam)               # (B*K,)
    last = first
    # a frozen beam may only continue with EOS, at cost 0
    eos_row = torch.full((v,), neg, device=dev)
    if eos_id is not None:
        eos_row[eos_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * beam

    for t in range(1, new_tokens):
        logits = _decode_logits(params, cfg, last.reshape(b * beam, 1),
                                caches, index, double_scale=double_scale)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(
            b, beam, v)
        logp = torch.where(finished[:, :, None], eos_row, logp)
        cand = (scores[:, :, None] + logp).reshape(b, beam * v)
        scores, idx = torch.topk(cand, beam, dim=-1)
        parent, tok = idx // v, idx % v
        flat_parent = (rows + parent).reshape(-1)
        _gather_caches(caches, flat_parent)
        index = index[flat_parent] + 1
        tokens = torch.gather(tokens, 1, parent[:, :, None].expand_as(tokens))
        finished_parent = torch.gather(finished, 1, parent)
        gen_len = torch.gather(gen_len, 1, parent) + (~finished_parent).long()
        finished = finished_parent | (tok == eos_id if eos_id is not None
                                      else False)
        # the buffer follows each beam's lineage, so position t is final
        tokens[:, :, t] = tok
        last = tok
    norm = scores / gen_len.float() ** length_penalty
    order = torch.argsort(-norm, dim=1)
    return (torch.gather(tokens, 1, order[:, :, None].expand_as(tokens)),
            torch.gather(norm, 1, order), torch.gather(scores, 1, order),
            torch.gather(gen_len, 1, order))


def _check_beam(beam_size: int, cfg: MagnetoConfig) -> None:
    if beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    if cfg.kv_window > 0:
        raise NotImplementedError(
            "beam search over a rolling KV window is not implemented "
            "(generate_text supports kv_window)")


@torch.inference_mode()
def beam_search(params, cfg: MagnetoConfig, prompt: torch.Tensor, *,
                beam_size: int = 4, max_new_tokens: int = 32,
                length_penalty: float = 1.0, eos_id: Optional[int] = None,
                prompt_lengths: Optional[torch.Tensor] = None,
                double_scale: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prompt (B, Lp) -> (tokens (B, K, T), normalised scores (B, K), raw
    log-probs (B, K)), beams sorted best first
    (kosmosx_tpu/generate/beam.py:210-238). ``tokens[:, 0]`` is the best
    sequence; positions after EOS hold repeated EOS."""
    _check_beam(beam_size, cfg)
    b, lp = prompt.shape
    max_len = lp + max_new_tokens
    if max_len > cfg.max_target_positions:
        raise ValueError(
            f"prompt ({lp}) + max_new_tokens ({max_new_tokens}) = {max_len} "
            f"exceeds the learned position table (max usable length "
            f"{cfg.max_target_positions}); raise max_positions")
    lengths = _lengths(prompt_lengths, b, lp, prompt.device)
    if double_scale:
        x, _ = dec.forward_embedding(
            params, cfg, token_embedding=dec.embed_only(params, cfg, prompt))
    else:
        x, _ = dec.forward_embedding(params, cfg, prompt)
    caches = dec.init_cache(cfg, b, max_len, device=prompt.device,
                            params=params)
    last = _prefill(params, cfg, x, caches, lengths)
    return _beam_from_logits(params, cfg, last, caches, lengths, beam_size,
                             max_new_tokens, length_penalty, eos_id,
                             double_scale)[:3]


@torch.inference_mode()
def beam_search_multimodal(model, kcfg: KosmosConfig, text_tokens: torch.Tensor,
                           images: torch.Tensor, *, beam_size: int = 4,
                           max_new_tokens: int = 32,
                           length_penalty: float = 1.0,
                           eos_id: Optional[int] = None,
                           prompt_lengths: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kosmos beam search: encode the image(s) and the text prompt once,
    then beam-decode with the parity double-scale embedding
    (kosmosx_tpu/generate/beam.py:241-268). Same return as
    ``beam_search``."""
    dcfg = kcfg.decoder
    _check_beam(beam_size, dcfg)
    max_len = _mm_max_len(kcfg, text_tokens, images, max_new_tokens)
    x, lengths = _mm_prompt(model, kcfg, text_tokens, images, prompt_lengths)
    caches = dec.init_cache(dcfg, x.shape[0], max_len, device=x.device,
                            params=model)
    last = _prefill(model["decoder"], dcfg, x, caches, lengths)
    return _beam_from_logits(model["decoder"], dcfg, last, caches, lengths,
                             beam_size, max_new_tokens, length_penalty,
                             eos_id, kcfg.parity_double_scale)[:3]
