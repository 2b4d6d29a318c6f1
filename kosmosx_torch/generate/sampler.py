"""Autoregressive generation with a KV cache
(counterpart of kosmosx_tpu/generate/sampler.py).

One prefill over the whole prompt writes the per-layer caches (the flash
kernel runs there once the prompt is 256 positions or longer), then a Python
loop decodes one token per step over the caches, which every step updates in
place. Prompts may be ragged: each row carries its own cache index. The
caches may hold int8 codes (``kv_cache_dtype="int8"``) or be a rolling
window (``kv_window``): sink slots and a ring, positions capped at the
learned table's end, and the xPos decay center slid forward every
``8 * xpos_scale_base`` steps (``nn/decoder.recenter_caches``), so that the
generation length is unbounded.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from kosmosx_torch.core.config import KosmosConfig, MagnetoConfig
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn.xpos import xpos_position_bound


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """kosmosx_tpu/generate/sampler.py:33-40."""

    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: int = 0           # 0 = disabled
    top_p: float = 1.0       # 1.0 = disabled
    greedy: bool = False
    eos_id: Optional[int] = None


def _cutoff(sorted_desc: torch.Tensor, cum: torch.Tensor, top_p) -> torch.Tensor:
    """The logit at which a nucleus of cumulative probability ``top_p`` ends:
    the smallest set with ``cum >= top_p``. The index is clamped to V - 1:
    the fp32 sum can end below a top_p that rounds to 1, where JAX's
    out-of-bounds gather fills NaN and keeps every id, as the last id's
    logit does."""
    idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(cum.shape[-1] - 1)
    return torch.gather(sorted_desc, -1, idx)


def filter_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """fp32 logits (B, V) after temperature, top-k and top-p, the dropped
    ids at -inf (kosmosx_tpu/generate/sampler.py:81-93). A top-k past V and
    a top-p cutoff past the last id keep every id, as JAX's clamped static
    index and its NaN-filled out-of-bounds gather do."""
    logits = logits.float()
    v = logits.shape[-1]
    if cfg.temperature != 1.0:
        logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -min(cfg.top_k, v)][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        logits = torch.where(logits < _cutoff(sorted_logits, cum, cfg.top_p),
                             -torch.inf, logits)
    return logits


def filter_logits_rows(logits: torch.Tensor, temps: torch.Tensor,
                       top_ks: torch.Tensor, top_ps: torch.Tensor
                       ) -> torch.Tensor:
    """Per-row temperature, top-k (0 off) and top-p (1 off), each (B,), on
    fp32 logits (B, V); dropped ids at -inf (kosmosx_tpu/generate/
    sampler.py:55-73). Top-k keeps the logits at or above the row's k-th
    largest (k clamped to [1, V]), top-p filters what top-k kept."""
    x = logits.float() / torch.clamp_min(temps, 1e-6)[:, None]
    v = x.shape[-1]
    sx = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(sx, -1, (top_ks - 1).clamp(0, v - 1)[:, None].long())
    x = torch.where((top_ks[:, None] > 0) & (x < kth), -torch.inf, x)
    sx = torch.sort(x, dim=-1, descending=True).values
    cum = torch.softmax(sx, dim=-1).cumsum(dim=-1)
    cutoff = _cutoff(sx, cum, top_ps[:, None])
    return torch.where((top_ps[:, None] < 1.0) & (x < cutoff), -torch.inf, x)


def sample_logits(logits: torch.Tensor, cfg: SamplingConfig,
                  generator: Optional[torch.Generator] = None,
                  rows=None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,): greedy, or temperature / top-k /
    top-p sampling from ``generator`` (kosmosx_tpu/generate/sampler.py:
    43-94).

    ``rows = (on, temps, top_ks, top_ps)``, each (B,): the rows where ``on``
    is set sample with their own temperature (0: greedy), top-k and top-p
    in place of ``cfg`` (``filter_logits_rows``); the others follow
    ``cfg``."""
    if rows is not None:
        on, temps, top_ks, top_ps = rows
        base = sample_logits(logits, cfg, generator)
        x = filter_logits_rows(logits, temps, top_ks, top_ps)
        sampled = torch.multinomial(torch.softmax(x, dim=-1), 1,
                                    generator=generator)[:, 0]
        greedy = logits.float().argmax(dim=-1)
        per_row = torch.where(temps <= 1e-6, greedy, sampled)
        return torch.where(on, per_row, base)
    if cfg.greedy:
        return logits.float().argmax(dim=-1)
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log p(token) in fp32 (kosmosx_tpu/generate/sampler.py:97-103)."""
    l32 = logits.float()
    true = torch.gather(l32, -1, tokens[..., None].long())[..., 0]
    return true - torch.logsumexp(l32, dim=-1)


def _prompt_segments(length: int, prompt_lengths: torch.Tensor) -> torch.Tensor:
    """0 for real prompt positions, -1 for right padding
    (kosmosx_tpu/generate/sampler.py:203-204, 298-300)."""
    pos = torch.arange(length, device=prompt_lengths.device)[None, :]
    return torch.where(pos < prompt_lengths[:, None], 0, -1).to(torch.int32)


def _prefill(params, cfg: MagnetoConfig, x: torch.Tensor, caches,
             prompt_lengths: torch.Tensor) -> torch.Tensor:
    """Run the embedded prompt ``x`` (B, Lp, D) through the stack, writing
    ``caches`` from index 0; the logits (B, V) at each row's last real
    position (kosmosx_tpu/generate/sampler.py:106-118)."""
    b, lp = x.shape[:2]
    h = dec.run_layers(params, x, cfg,
                       segment_ids=_prompt_segments(lp, prompt_lengths),
                       caches=caches, cache_index=0, prefill=True)
    last = h[torch.arange(b, device=x.device), prompt_lengths - 1]
    return dec.output_logits(params, last, cfg)


def _decode_logits(params, cfg: MagnetoConfig, tokens: torch.Tensor, caches,
                   index: torch.Tensor, *, double_scale: bool = False,
                   shared=None, xpos_center=None) -> torch.Tensor:
    """Cached forward of ``tokens`` (B, L) at per-row ``index`` (B,): logits
    (B, L, V) in the compute dtype (kosmosx_tpu/generate/speculative.py:
    51-74 and the step of sampler.py:145-167). ``double_scale`` embeds like
    a parity-mode Kosmos training forward (embed_scale twice); ``shared =
    (shared_caches, shared_on, pos_offset)`` a shared prefix; under
    ``kv_window`` positions stop at the learned table's last row."""
    shared_caches, shared_on, pos_offset = shared or (None, None, None)
    pos = index if pos_offset is None else index + pos_offset
    if cfg.kv_window > 0:
        pos = pos.clamp_max(cfg.max_target_positions - 1)
    if double_scale:
        emb = dec.embed_only(params, cfg, tokens)
        x, _ = dec.forward_embedding(params, cfg, token_embedding=emb,
                                     offset=pos[:, None])
    else:
        x, _ = dec.forward_embedding(params, cfg, tokens, offset=pos[:, None])
    h = dec.run_layers(params, x, cfg, caches=caches, cache_index=index,
                       shared_caches=shared_caches, shared_on=shared_on,
                       pos_offset=pos_offset, xpos_center=xpos_center)
    return dec.output_logits(params, h, cfg)


@dataclasses.dataclass
class DecodeState:
    """Where a decode loop stands: the last token (B,), not yet cached; the
    caches; the cache index (B,) of that token; under a rolling window the
    xPos center (B,) and ``reach``, how far the furthest row has run past
    it (every row advances one position a step, so the host keeps it and
    no step waits on the device); rows that emitted EOS."""

    tok: torch.Tensor
    caches: List
    index: torch.Tensor
    done: torch.Tensor
    center: Optional[torch.Tensor] = None
    reach: int = 0


def _decode(params, cfg: MagnetoConfig, state: DecodeState, steps: int,
            scfg: SamplingConfig, generator, double_scale: bool = False
            ) -> Tuple[List[torch.Tensor], DecodeState]:
    """``steps`` decode steps from ``state``: the ids sampled at each step
    and the state after them. Under ``kv_window`` with xPos every key is
    re-centered once the furthest row runs ``8 * xpos_scale_base``
    positions past its center (kosmosx_tpu/generate/sampler.py:121-182),
    after which every row's center is its index."""
    recenter_every = 8 * cfg.xpos_scale_base
    out = []
    for _ in range(steps):
        if state.center is not None and state.reach >= recenter_every:
            state.caches = dec.recenter_caches(
                state.caches, state.index - state.center, cfg)
            state.center, state.reach = state.index.clone(), 0
        logits = _decode_logits(params, cfg, state.tok[:, None], state.caches,
                                state.index, double_scale=double_scale,
                                xpos_center=state.center)
        nxt = sample_logits(logits[:, 0], scfg, generator)
        if scfg.eos_id is not None:
            nxt = torch.where(state.done, scfg.eos_id, nxt)
            state.done = state.done | (nxt == scfg.eos_id)
        out.append(nxt)
        state.tok, state.index = nxt, state.index + 1
        state.reach += 1
    return out, state


def _generate(params, cfg: MagnetoConfig, x: torch.Tensor,
              prompt_lengths: torch.Tensor, scfg: SamplingConfig,
              max_len: int, generator, double_scale: bool
              ) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill the embedded prompt ``x``, then decode: (B, T) ids and the
    final decode state."""
    if cfg.kv_window > 0:
        max_len = min(max_len, cfg.kv_window)  # O(window) memory
    caches = dec.init_cache(cfg, x.shape[0], max_len, device=x.device,
                            params=params)
    last = _prefill(params, cfg, x, caches, prompt_lengths)
    tok = sample_logits(last, scfg, generator)
    done = (tok == scfg.eos_id if scfg.eos_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    state = DecodeState(tok, caches, prompt_lengths.clone(), done)
    if cfg.kv_window > 0 and cfg.xpos_rel_pos:
        # the prefill wrote keys at center 0
        state.center = torch.zeros_like(prompt_lengths)
        state.reach = int(prompt_lengths.max())
    out, state = _decode(params, cfg, state, scfg.max_new_tokens - 1, scfg,
                         generator, double_scale)
    return torch.stack([tok] + out, dim=1), state


def _lengths(prompt_lengths, b: int, lt: int, device) -> torch.Tensor:
    if prompt_lengths is None:
        return torch.full((b,), lt, dtype=torch.long, device=device)
    return torch.as_tensor(prompt_lengths, device=device).long()


def _check_window(cfg: MagnetoConfig, lp: int) -> None:
    """The guards of rolling-window generation
    (kosmosx_tpu/generate/sampler.py:233-256): the prompt is one unwrapped
    prefill, so it must fit the window and the table; with re-centering the
    furthest distance from a center is the window plus the interval."""
    if cfg.kv_sink >= cfg.kv_window:
        raise ValueError(f"kv_sink ({cfg.kv_sink}) must be < kv_window "
                         f"({cfg.kv_window})")
    if lp > cfg.kv_window:
        raise ValueError(f"prompt ({lp}) exceeds kv_window ({cfg.kv_window})")
    if lp > cfg.max_target_positions:
        raise ValueError(f"prompt ({lp}) exceeds the learned position "
                         f"table ({cfg.max_target_positions})")
    if cfg.xpos_rel_pos:
        bound = xpos_position_bound(cfg.xpos_scale_base)
        if cfg.kv_window + 8 * cfg.xpos_scale_base > bound:
            raise ValueError(
                f"kv_window ({cfg.kv_window}) + re-center interval "
                f"({8 * cfg.xpos_scale_base}) exceeds the xPos numeric "
                f"range bound ({bound} at scale_base {cfg.xpos_scale_base});"
                f" raise xpos_scale_base or shrink the window")


@torch.inference_mode()
def generate_text(params, cfg: MagnetoConfig, prompt: torch.Tensor,
                  sampling: Optional[SamplingConfig] = None,
                  prompt_lengths: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt (B, Lp), right-padded -> generated ids (B, max_new_tokens)
    (kosmosx_tpu/generate/sampler.py:215-265). ``params`` is the decoder
    tree, e.g. a ``KosmosLanguage``. With ``kv_window`` the generation
    length is unbounded at a window-sized cache."""
    sampling = sampling or SamplingConfig()
    b, lp = prompt.shape
    max_len = lp + sampling.max_new_tokens
    if cfg.kv_window > 0:
        _check_window(cfg, lp)
    elif max_len > cfg.max_target_positions:
        raise ValueError(
            f"prompt ({lp}) + max_new_tokens ({sampling.max_new_tokens}) = "
            f"{max_len} exceeds the learned position table (max usable length "
            f"{cfg.max_target_positions}); raise max_positions")
    lengths = _lengths(prompt_lengths, b, lp, prompt.device)
    x, _ = dec.forward_embedding(params, cfg, prompt)
    return _generate(params, cfg, x, lengths, sampling, max_len, generator,
                     double_scale=False)[0]


def _mm_max_len(kcfg: KosmosConfig, text_tokens, images, new: int) -> int:
    """The cache length of a Kosmos request, checked against the learned
    table (kosmosx_tpu/generate/sampler.py:327-339)."""
    lt = text_tokens.shape[1]
    num_images = images.shape[1] if images.ndim == 5 else 1
    max_len = lt + num_images * kcfg.image_embed_len + new
    if max_len > kcfg.decoder.max_target_positions:
        raise ValueError(
            f"text ({lt}) + image embeds ({num_images * kcfg.image_embed_len})"
            f" + max_new_tokens ({new}) = {max_len} exceeds the learned "
            f"position table (max usable length "
            f"{kcfg.decoder.max_target_positions}); raise max_positions")
    return max_len


def _mm_prompt(model, kcfg: KosmosConfig, text_tokens, images, prompt_lengths):
    """The embedded image+text prompt and its lengths, every image block
    counted as prompt."""
    lengths = _lengths(prompt_lengths, *text_tokens.shape, text_tokens.device)
    x, num_images = model.embed_prompt(text_tokens, images)
    return x, lengths + num_images * kcfg.image_embed_len


@torch.inference_mode()
def generate_multimodal(model, kcfg: KosmosConfig, text_tokens: torch.Tensor,
                        images: torch.Tensor,
                        sampling: Optional[SamplingConfig] = None,
                        prompt_lengths: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Kosmos generation: encode the image(s) and the text prompt once, then
    decode (kosmosx_tpu/generate/sampler.py:272-339). ``model`` is a
    ``Kosmos``; ``prompt_lengths`` counts text tokens, and every image block
    counts as prompt. A rolling window is not supported here, as in JAX."""
    sampling = sampling or SamplingConfig()
    if kcfg.decoder.kv_window > 0:
        raise NotImplementedError(
            "multimodal generation over a rolling KV window is not "
            "implemented (generate_text supports kv_window)")
    max_len = _mm_max_len(kcfg, text_tokens, images, sampling.max_new_tokens)
    x, lengths = _mm_prompt(model, kcfg, text_tokens, images, prompt_lengths)
    return _generate(model["decoder"], kcfg.decoder, x, lengths, sampling,
                     max_len, generator,
                     double_scale=kcfg.parity_double_scale)[0]
