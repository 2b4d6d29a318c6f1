"""Speculative decoding: a small draft model proposes, the target verifies
(counterpart of kosmosx_tpu/generate/speculative.py).

Each round the draft runs gamma + 1 one-token cached steps (the last
proposal is dropped, but its step leaves the draft cache holding the whole
chunk), the target runs one chunked cached forward over ``[carry, d_1 ..
d_gamma]`` (gamma + 1 positions at per-row indices: plain attention with
the causal offset, neither a prefill nor a one-token step), and the
longest accepted prefix is committed with the target's own token after it.
Greedy acceptance compares with the target's argmax, so greedy outputs are
``generate_text``'s; with a temperature, Leviathan-style rejection sampling
keeps the target's distribution. Rounds go on until every row has its
``max_new_tokens``: one host read a round, not a token. Rejected drafts need
no rollback: cache slots past a row's index are never attended and the
next round writes over them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kosmosx_torch.core.config import MagnetoConfig
from kosmosx_torch.generate.sampler import (SamplingConfig, _decode_logits,
                                            _lengths, _prefill, sample_logits,
                                            token_logprob)
from kosmosx_torch.nn import decoder as dec


def _probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.softmax(logits / max(temperature, 1e-6), dim=-1)


def spec_round(params_t, params_d, cfg_t: MagnetoConfig, cfg_d: MagnetoConfig,
               scfg: SamplingConfig, gamma: int, carry_tok, index, caches_t,
               caches_d, generator=None, *, double_scale_t: bool = False,
               index_d=None, shared_t=None, shared_d=None):
    """One round over a (B,) batch or slot pool: draft gamma tokens, verify
    them in one chunked target forward, accept
    (kosmosx_tpu/generate/speculative.py:81-182). Both caches are written in
    place.

    Returns ``(emit, emit_lp, n_acc, carry_next)``: ``emit`` (B, gamma + 1)
    holds d_1 .. d_{n_acc} and then the correction (or bonus) token at
    position ``n_acc``, which is ``carry_next``, the next round's carry
    token; entries past it are junk. ``emit_lp`` holds the target's fp32
    log-probs of ``emit`` (position j's logits scored the token emitted at
    j). The caller commits as many as it wants and advances ``index``
    itself.

    The serving engine's arguments: ``double_scale_t`` embeds the target
    like a parity-mode Kosmos; ``index_d`` (B,) is the draft's own cache
    index where it differs from ``index`` (a multimodal slot's draft never
    saw the image embeddings; default ``index``); ``shared_t``/``shared_d``
    = (shared_caches, shared_on, pos_offset) each model's shared-prefix
    segment."""
    if index_d is None:
        index_d = index
    b = carry_tok.shape[0]
    dev = carry_tok.device
    tok, d_toks, p_d = carry_tok, [], []
    for i in range(gamma + 1):
        logits = _decode_logits(params_d, cfg_d, tok[:, None], caches_d,
                                index_d + i, shared=shared_d)[:, 0].float()
        tok = sample_logits(logits, scfg, generator)
        d_toks.append(tok)
        p_d.append(_probs(logits, scfg.temperature))
    d_toks = torch.stack(d_toks[:gamma], dim=1)             # (B, gamma)
    p_d = torch.stack(p_d, dim=1)                           # (B, gamma+1, V)
    bi = torch.arange(b, device=dev)
    gi = torch.arange(gamma, device=dev)

    chunk = torch.cat([carry_tok[:, None], d_toks], dim=1)
    logits_t = _decode_logits(params_t, cfg_t, chunk, caches_t, index,
                              double_scale=double_scale_t,
                              shared=shared_t).float()     # (B, gamma+1, V)
    if scfg.greedy:
        corrections = logits_t.argmax(dim=-1)
        match = d_toks == corrections[:, :gamma]
        n_acc = match.long().cumprod(dim=1).sum(dim=1)
    else:
        # accept d_i with probability min(1, p_t / p_d)
        p_t_all = _probs(logits_t, scfg.temperature)
        p_t = p_t_all[bi[:, None], gi[None, :], d_toks]
        d_probs = p_d[bi[:, None], gi[None, :], d_toks]
        u = torch.rand(b, gamma, generator=generator, device=dev)
        accept = u < torch.clamp_max(p_t / torch.clamp_min(d_probs, 1e-20), 1.0)
        n_acc = accept.long().cumprod(dim=1).sum(dim=1)
        # resample from max(0, p_t - p_d) at the first rejection; at the
        # bonus position (all accepted) that is p_t
        sel = torch.clamp_max(n_acc, gamma)
        resid = torch.clamp_min(p_t_all[bi, sel] - torch.where(
            (sel < gamma)[:, None], p_d[bi, sel], 0.0), 0.0)
        resid = resid / torch.clamp_min(resid.sum(-1, keepdim=True), 1e-20)
        corr = torch.multinomial(resid + 1e-20, 1, generator=generator)[:, 0]
        corrections = corr[:, None].expand(b, gamma + 1)
    carry_next = corrections[bi, torch.clamp_max(n_acc, gamma)]
    emit = torch.cat([d_toks, carry_next[:, None]], dim=1)
    emit[bi, n_acc] = carry_next
    return emit, token_logprob(logits_t, emit), n_acc, carry_next


@torch.inference_mode()
def speculative_generate(params_target, params_draft,
                         cfg_target: MagnetoConfig, cfg_draft: MagnetoConfig,
                         prompt: torch.Tensor,
                         sampling: Optional[SamplingConfig] = None, *,
                         gamma: int = 4,
                         prompt_lengths: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, dict]:
    """prompt (B, Lp) -> (generated ids (B, max_new_tokens), stats)
    (kosmosx_tpu/generate/speculative.py:276-318). Greedy outputs are
    ``generate_text``'s on the target alone; temperature-sampled ones follow
    the target's distribution. ``stats``: host ints ``rounds``,
    ``accepted`` and ``proposed`` (acceptance rate = accepted /
    proposed)."""
    scfg = sampling or SamplingConfig(greedy=True)
    if not scfg.greedy and (scfg.top_k > 0 or scfg.top_p < 1.0):
        raise NotImplementedError(
            "speculative decoding supports greedy or temperature sampling; "
            "top-k/top-p filtering is not implemented")
    if cfg_target.kv_window > 0 or cfg_draft.kv_window > 0:
        raise NotImplementedError(
            "speculative decoding over a rolling KV window is not "
            "implemented (the multi-token verify bypasses the ring); use "
            "generate_text for windowed generation")
    b, lp = prompt.shape
    dev = prompt.device
    # headroom: the last round may write gamma speculative cache entries
    max_len = lp + scfg.max_new_tokens + gamma + 1
    for cfg in (cfg_target, cfg_draft):
        if max_len > cfg.max_target_positions:
            raise ValueError(
                f"prompt + max_new_tokens + gamma = {max_len} exceeds the "
                f"position table ({cfg.max_target_positions}); raise "
                f"max_positions")
    lengths = _lengths(prompt_lengths, b, lp, dev)
    fill = scfg.eos_id if scfg.eos_id is not None else 0
    new = scfg.max_new_tokens

    caches_t = dec.init_cache(cfg_target, b, max_len, device=dev,
                              params=params_target)
    x_t, _ = dec.forward_embedding(params_target, cfg_target, prompt)
    last = _prefill(params_target, cfg_target, x_t, caches_t, lengths)
    caches_d = dec.init_cache(cfg_draft, b, max_len, device=dev,
                              params=params_draft)
    x_d, _ = dec.forward_embedding(params_draft, cfg_draft, prompt)
    _prefill(params_draft, cfg_draft, x_d, caches_d, lengths)

    carry_tok = sample_logits(last, scfg, generator)        # committed token 0
    # a spare column past the end takes the writes that fall out of range
    out = torch.full((b, new + 1), fill, dtype=torch.long, device=dev)
    out[:, 0] = carry_tok
    out_pos = torch.ones(b, dtype=torch.long, device=dev)
    done = (carry_tok == scfg.eos_id if scfg.eos_id is not None
            else torch.zeros(b, dtype=torch.bool, device=dev))
    index = lengths.clone()
    offs = torch.arange(gamma + 1, device=dev)[None, :]
    rounds = n_accepted = n_proposed = 0
    while not bool(done.all()):
        emit, _, n_acc, _ = spec_round(params_target, params_draft, cfg_target,
                                    cfg_draft, scfg, gamma, carry_tok, index,
                                    caches_t, caches_d, generator)
        n_emit = torch.where(done, 0, n_acc + 1)
        if scfg.eos_id is not None:
            # nothing after the first EOS of the window is committed
            is_eos = (emit == scfg.eos_id).long()
            upto_eos = (is_eos.cumsum(1).cumsum(1) <= 1).long().sum(1)
            n_emit = torch.minimum(n_emit, upto_eos)
        pos = out_pos[:, None] + offs
        valid = (offs < n_emit[:, None]) & (pos < new)
        out.scatter_(1, torch.where(valid, pos, new),
                     torch.where(valid, emit, fill))
        out_pos = out_pos + n_emit
        # a row that finished inside this round may stand past its last
        # position; while other rows run on, its rounds write gamma + 1
        # junk cache entries from its index: keep them inside the cache
        # (JAX drops such writes). A running row stays below the clamp.
        index = torch.clamp_max(index + n_emit, max_len - gamma - 1)
        if scfg.eos_id is not None:
            done = done | ((emit == scfg.eos_id)
                           & (offs < n_emit[:, None])).any(dim=1)
        done = done | (out_pos >= new)
        carry_tok = torch.where(done, carry_tok, emit[torch.arange(b, device=dev),
                                                      n_acc])
        rounds += 1
        n_accepted = n_accepted + torch.where(done, 0, n_acc).sum()
        n_proposed = n_proposed + (~done).sum() * gamma
    return out[:, :new], {"rounds": rounds, "accepted": int(n_accepted),
                          "proposed": int(n_proposed)}
