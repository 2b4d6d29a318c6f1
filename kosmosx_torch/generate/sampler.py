"""Autoregressive generation with a KV cache
(counterpart of kosmosx_tpu/generate/sampler.py).

One prefill over the whole prompt writes the per-layer caches (the flash
kernel runs there once the prompt is 256 positions or longer), then a Python
loop decodes one token per step over the caches, which every step updates in
place. Prompts may be ragged: each row carries its own cache index.
``kv_window`` (rolling cache) and the per-row sampling overrides of the
serving engine are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from kosmosx_torch.core.config import KosmosConfig, MagnetoConfig
from kosmosx_torch.nn import decoder as dec


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """kosmosx_tpu/generate/sampler.py:33-40."""

    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: int = 0           # 0 = disabled
    top_p: float = 1.0       # 1.0 = disabled
    greedy: bool = False
    eos_id: Optional[int] = None


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
        # keep the smallest set with cumulative probability >= top_p; the
        # fp32 sum can end below a top_p that rounds to 1
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True).clamp_max(v - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_logits(logits: torch.Tensor, cfg: SamplingConfig,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,): greedy, or temperature / top-k /
    top-p sampling from ``generator`` (kosmosx_tpu/generate/sampler.py:
    78-94)."""
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


def _generate(params, cfg: MagnetoConfig, x: torch.Tensor,
              prompt_lengths: torch.Tensor, scfg: SamplingConfig,
              max_len: int, generator, double_scale: bool) -> torch.Tensor:
    """Prefill the embedded prompt ``x``, then decode; returns (B, T) ids."""
    b, lp = x.shape[:2]
    caches = dec.init_cache(cfg, b, max_len, device=x.device)
    h = dec.run_layers(params, x, cfg,
                       segment_ids=_prompt_segments(lp, prompt_lengths),
                       caches=caches, cache_index=0, prefill=True)
    # logits of each row's last real prompt position
    last = h[torch.arange(b, device=x.device), prompt_lengths - 1]
    tok = sample_logits(dec.output_logits(params, last, cfg), scfg, generator)
    done = (tok == scfg.eos_id if scfg.eos_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    out = [tok]
    index = prompt_lengths.clone()
    for _ in range(scfg.max_new_tokens - 1):
        if double_scale:
            # decode embeds match the parity-mode training forward, which
            # applies embed_scale twice (kosmosx_tpu/generate/sampler.py:159)
            emb = dec.embed_only(params, cfg, tok[:, None])
            xt, _ = dec.forward_embedding(params, cfg, token_embedding=emb,
                                          offset=index[:, None])
        else:
            xt, _ = dec.forward_embedding(params, cfg, tok[:, None],
                                          offset=index[:, None])
        h = dec.run_layers(params, xt, cfg, caches=caches, cache_index=index)
        nxt = sample_logits(dec.output_logits(params, h[:, 0], cfg), scfg,
                            generator)
        if scfg.eos_id is not None:
            nxt = torch.where(done, scfg.eos_id, nxt)
            done = done | (nxt == scfg.eos_id)
        out.append(nxt)
        tok = nxt
        index = index + 1
    return torch.stack(out, dim=1)


def _lengths(prompt_lengths, b: int, lt: int, device) -> torch.Tensor:
    if prompt_lengths is None:
        return torch.full((b,), lt, dtype=torch.long, device=device)
    return torch.as_tensor(prompt_lengths, device=device).long()


@torch.inference_mode()
def generate_text(params, cfg: MagnetoConfig, prompt: torch.Tensor,
                  sampling: Optional[SamplingConfig] = None,
                  prompt_lengths: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt (B, Lp), right-padded -> generated ids (B, max_new_tokens)
    (kosmosx_tpu/generate/sampler.py:215-265). ``params`` is the decoder
    tree, e.g. a ``KosmosLanguage``."""
    sampling = sampling or SamplingConfig()
    b, lp = prompt.shape
    max_len = lp + sampling.max_new_tokens
    if max_len > cfg.max_target_positions:
        raise ValueError(
            f"prompt ({lp}) + max_new_tokens ({sampling.max_new_tokens}) = "
            f"{max_len} exceeds the learned position table (max usable length "
            f"{cfg.max_target_positions}); raise max_positions")
    lengths = _lengths(prompt_lengths, b, lp, prompt.device)
    x, _ = dec.forward_embedding(params, cfg, prompt)
    return _generate(params, cfg, x, lengths, sampling, max_len, generator,
                     double_scale=False)


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
    counts as prompt."""
    sampling = sampling or SamplingConfig()
    dcfg = kcfg.decoder
    b, lt = text_tokens.shape
    num_images = images.shape[1] if images.ndim == 5 else 1
    max_len = lt + num_images * kcfg.image_embed_len + sampling.max_new_tokens
    if max_len > dcfg.max_target_positions:
        raise ValueError(
            f"text ({lt}) + image embeds ({num_images * kcfg.image_embed_len})"
            f" + max_new_tokens ({sampling.max_new_tokens}) = {max_len} "
            f"exceeds the learned position table (max usable length "
            f"{dcfg.max_target_positions}); raise max_positions")
    lengths = _lengths(prompt_lengths, b, lt, text_tokens.device)
    x, num_images = model.embed_prompt(text_tokens, images)
    return _generate(model["decoder"], dcfg, x,
                     lengths + num_images * kcfg.image_embed_len, sampling,
                     max_len, generator,
                     double_scale=kcfg.parity_double_scale)
