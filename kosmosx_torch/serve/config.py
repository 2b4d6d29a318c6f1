"""Serving configuration, request handles and the mode-compatibility matrix
(counterpart of kosmosx_tpu/serve/config.py).

``ServeConfig`` has the JAX fields with the same names and defaults, so the
serving CLI's flags and the tests carry over; ``overrun_window`` is the
same integer as JAX's for every setting. JAX tuned several fields for a
remote TPU link and for per-shape compiles. Here each keeps its contract
(greedy token streams identical for every setting), implemented with what
the card offers:

- ``sync_lag``, ``drain_batch``, ``async_drain``: each dispatch copies its
  (tokens, log-probs) into pinned host memory with ``non_blocking=True``
  and records a CUDA event; a drain waits on the event (the async reader
  thread does so with the GIL released). No other call of ``step()``
  reads the device.
- ``eager_copy`` and ``unroll_min_len`` are accepted and have no effect:
  the copy is always started at dispatch, and the pool always is the
  per-layer list (as ``MagnetoConfig.decode_unroll*``).
- ``decode_block``: K decode steps per ``step()``, the token fed back on
  the device, no host read between them.
- ``decode_kernel_fill`` picks between ``cfg`` and its
  ``decode_attn_kernel=True`` variant per dispatch, by the host-known fill,
  as JAX does.
- ``prompt_buckets`` decide the padding and the admission grouping, as in
  JAX.

Every unsupported pairing of engine modes fails at construction (or at the
request-shaping call: submit / load_adapter / register_prefix), never
mid-flight; ``UNSUPPORTED_MODE_PAIRS`` is the one table of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """kosmosx_tpu/serve/config.py:21-142; the fields' contracts are
    documented there."""

    max_batch: int = 8          # concurrent decode slots
    max_prompt_len: int = 128   # prompts are padded to this
    max_len: int = 256          # KV-cache length (prompt + generated bound)
    pad_id: int = 1             # feed for inactive slots
    # decode steps the host may lag behind the device when reading tokens;
    # EOS is seen that many steps late (the budget is clamped on the host)
    sync_lag: int = 0
    # drains read this many steps' tokens at once
    drain_batch: int = 1
    # a reader thread waits on the copies while the loop dispatches
    async_drain: bool = True
    # accepted, no effect: the copy always starts at dispatch
    eager_copy: bool = True
    # > 0: one speculative round per step with a draft model
    spec_gamma: int = 0
    # > 1: this many decode steps (or spec rounds) per step()
    decode_block: int = 0
    # > 0: prompts stream in this many tokens a step
    prefill_chunk: int = 0
    # batch-1 prefills pad to the smallest bucket that fits
    prompt_buckets: tuple = ()
    # LRU size of the copy-mode prefix cache
    prefix_cache_size: int = 8
    # > 0: low-fill dispatches take the decode_attn_kernel=True variant
    decode_kernel_fill: float = 0.0
    # accepted, no effect: the pool always is the per-layer list
    unroll_min_len: Optional[int] = None

    @property
    def overrun_window(self) -> int:
        """Cache positions a slot can touch past its budget (worst-case
        EOS or speculative overrun): ``max_len`` must cover prompt + image
        embeds + max_new_tokens + this. Async drains bound the un-bookkept
        steps to sync_lag + 3 * drain_batch, plus the next dispatch."""
        kb = max(self.drain_batch, 1)
        lag = (self.sync_lag + 3 * kb + 1 if self.async_drain
               else self.sync_lag + kb)
        if self.spec_gamma > 0:
            return lag * (self.spec_gamma + 1) * max(self.decode_block, 1)
        return lag * max(self.decode_block, 1) - 1


@dataclasses.dataclass
class Request:
    """A request's handle (kosmosx_tpu/serve/config.py:145-164)."""

    prompt: Any                  # (Lp,) token ids
    max_new_tokens: int = 64
    eos_id: Optional[int] = None
    images: Any = None           # optional (M, 3, H, W) for multimodal
    adapter: Optional[str] = None  # LoRA adapter name (load_adapter)
    # per-request sampling overrides: when any is set, this request's row
    # replaces the engine's SamplingConfig (temperature 0 = greedy, top_k
    # 0 = off, top_p 1.0 = off; unset fields default to 1.0 / 0 / 1.0)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # filled by the engine:
    id: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False


# Engine modes (how each is switched on):
#   spec        ServeConfig.spec_gamma > 0 (+ draft_params/draft_cfg)
#   chunked     ServeConfig.prefill_chunk > 0
#   blocked     ServeConfig.decode_block > 1
#   kv_window   MagnetoConfig.kv_window > 0 (rolling ring + sinks)
#   kv8         MagnetoConfig.kv_cache_dtype == "int8"
#   w8          int8-quantized params (utils/quantize.quantize_params_w8)
#   multimodal  engine built with kosmos_cfg; requests may carry images
#   prefix_copy register_prefix(tokens)
#   prefix_share register_prefix(tokens, share=True)
#   adapter     load_adapter(name, tree) + submit(adapter=name)
#   sampling_override  submit(temperature=/top_k=/top_p=)
# Every pair not listed is supported.
UNSUPPORTED_MODE_PAIRS = {
    frozenset({"kv_window", "spec"}):
        "kv_window serving does not compose with speculation "
        "(the multi-token verify bypasses the ring)",
    frozenset({"chunked", "spec"}):
        "chunked prefill + speculative serving is not implemented "
        "(the draft pool would need chunked ingestion too)",
    frozenset({"adapter", "spec"}):
        "multi-LoRA + speculative serving is not implemented "
        "(the draft would need per-slot adapters too)",
    frozenset({"adapter", "multimodal"}):
        "multi-LoRA serving is text-only for now (adapters attach to the "
        "decoder; build the engine without kosmos_cfg)",
    frozenset({"sampling_override", "spec"}):
        "per-request sampling with speculative serving is not implemented "
        "(the draft/verify acceptance rule is engine-global); set the "
        "engine SamplingConfig instead",
    # adapter requests skip both prefix paths (registered prefixes are
    # prefilled with the base model): supported with degradation
}


def unsupported_reason(*modes: str) -> Optional[str]:
    """The matrix reason for the first unsupported pair among ``modes``."""
    on = [m for m in modes if m]
    for i, a in enumerate(on):
        for b in on[i + 1:]:
            reason = UNSUPPORTED_MODE_PAIRS.get(frozenset({a, b}))
            if reason is not None:
                return reason
    return None


def check_engine_modes(cfg, scfg: ServeConfig, draft_cfg=None,
                       kosmos_cfg=None, sampling=None) -> None:
    """Construction-time validation (kosmosx_tpu/serve/config.py:
    231-307): every statically knowable unsupported pairing raises here."""
    from kosmosx_torch.nn.xpos import xpos_position_bound

    spec = scfg.spec_gamma > 0
    window = cfg.kv_window > 0 or (draft_cfg is not None
                                   and draft_cfg.kv_window > 0)
    modes = []
    if spec:
        modes.append("spec")
    if scfg.prefill_chunk > 0:
        modes.append("chunked")
    if window:
        modes.append("kv_window")
    reason = unsupported_reason(*modes)
    if reason is not None:
        raise NotImplementedError(reason)
    if spec and sampling is not None and (
            sampling.top_k > 0
            or (not sampling.greedy and sampling.top_p < 1.0)):
        raise NotImplementedError(
            "speculative serving supports greedy or plain temperature "
            "sampling")
    if not window:
        return
    # rolling-window serving: prompts fit the window (one unwrapped
    # prefill), and re-centering bounds |pos - center| by the window plus
    # the re-center interval
    if draft_cfg is not None and draft_cfg.kv_window != cfg.kv_window:
        raise ValueError("draft kv_window must match the target's")
    if cfg.kv_sink >= cfg.kv_window:
        raise ValueError(f"kv_sink ({cfg.kv_sink}) must be < "
                         f"kv_window ({cfg.kv_window})")
    if scfg.max_prompt_len > cfg.kv_window:
        raise ValueError(
            f"max_prompt_len ({scfg.max_prompt_len}) exceeds "
            f"kv_window ({cfg.kv_window}); prompts must fit the "
            f"window (prefill is a single un-wrapped write)")
    if scfg.max_len < cfg.kv_window:
        raise ValueError(
            f"max_len ({scfg.max_len}) < kv_window ({cfg.kv_window}): ring "
            f"writes target positions in [0, kv_window); set max_len >= "
            f"kv_window")
    if cfg.xpos_rel_pos:
        bound = xpos_position_bound(cfg.xpos_scale_base)
        reach = cfg.kv_window + 8 * cfg.xpos_scale_base
        if reach > bound:
            raise ValueError(
                f"kv_window ({cfg.kv_window}) + re-center interval "
                f"(8*xpos_scale_base = {8 * cfg.xpos_scale_base}) = {reach} "
                f"exceeds the xPos numeric range ({bound}); shrink the "
                f"window or raise xpos_scale_base")
