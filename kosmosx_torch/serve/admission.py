"""Request admission for the serving engine (counterpart of
kosmosx_tpu/serve/admission.py): submit validation, prefix caching (copy
and shared-segment modes), multi-LoRA adapters, per-request sampling
overrides, chunked prompt ingestion and warmup.

``AdmissionMixin`` holds no state of its own: it works on the attributes
``ServeEngine.__init__`` sets up. The host logic and the raises are JAX's,
call for call, with three of JAX's open review findings fixed:

- requests with sampling overrides keep the batch-1 admission path
  (``_batchable``), so a batched admission is always the one program
  ``warmup`` ran;
- the batched admission has one group size, ``_admit_bucket``, and the
  docstrings say so;
- ``warmup`` warns where it cannot form a full batched-admission group,
  in place of a branch that did nothing.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np
import torch

from kosmosx_torch.serve.config import Request, unsupported_reason
from kosmosx_torch.serve.programs import (_insert_rows, _insert_slot,
                                          _prefill_chunk_pool, _prefill_mm_one,
                                          _prefill_mm_prefix, _prefill_one,
                                          _prefill_suffix, _slot_view,
                                          _trim_shared)
from kosmosx_torch.utils import trace


def _suffix_bucket(n: int, cap: int) -> int:
    """The padded width of a prefix hit's suffix prefill: the next power of
    two (at least 8), capped at ``max_prompt_len``
    (kosmosx_tpu/serve/admission.py:28-35)."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _host_ints(tokens) -> list:
    """Token ids as a Python list; one read for a tensor on the card."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().cpu().numpy()
    return [int(t) for t in np.asarray(tokens, np.int64).ravel()]


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


class AdmissionMixin:
    """The admission half of ``ServeEngine`` (engine.py holds the decode
    loop)."""

    # -- request API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 64,
               eos_id: Optional[int] = None, images=None,
               adapter: Optional[str] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> Request:
        """Queue a request and return its handle
        (kosmosx_tpu/serve/admission.py:43-136)."""
        if adapter is not None and adapter not in self.adapters:
            raise KeyError(f"unknown adapter {adapter!r}; load_adapter first")
        if adapter is not None and images is not None:
            raise NotImplementedError("multi-LoRA serving is text-only")
        if temperature is not None and temperature < 0:
            raise ValueError("temperature must be >= 0")
        if top_k is not None and top_k < 0:
            raise ValueError("top_k must be >= 0")
        if top_p is not None and not (0.0 < top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if temperature is not None or top_k is not None or top_p is not None:
            reason = unsupported_reason("sampling_override",
                                        "spec" if self.spec else None)
            if reason is not None:
                raise NotImplementedError(reason)
        prompt = _host_ints(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.scfg.max_prompt_len:
            raise ValueError(f"prompt len {len(prompt)} > max_prompt_len "
                             f"{self.scfg.max_prompt_len}")
        extra = 0
        if images is not None:
            if self.kcfg is None:
                raise ValueError("engine was built without kosmos_cfg; "
                                 "multimodal requests need one")
            extra = (images.shape[0] if images.ndim == 4 else 1) \
                * self.kcfg.image_embed_len
        # headroom for EOS detection lag, speculative rounds and blocks
        window = self.scfg.overrun_window
        if self.cfg.kv_window > 0:
            from kosmosx_torch.nn.xpos import xpos_position_bound

            if len(prompt) + extra > self.cfg.kv_window:
                raise ValueError(
                    f"prompt ({len(prompt)}) + image embeds ({extra}) "
                    f"exceeds kv_window ({self.cfg.kv_window})")
            if self.cfg.xpos_rel_pos and self.shared_seg is not None:
                # a shared prefix turns re-centering off: budgets are then
                # bounded by the xPos numeric range
                bound = xpos_position_bound(self.cfg.xpos_scale_base)
                if len(prompt) + extra + max_new_tokens + window > bound:
                    raise ValueError(
                        f"prompt + image embeds + max_new_tokens = "
                        f"{len(prompt) + extra + max_new_tokens} exceeds "
                        f"the xPos numeric range bound ({bound}); "
                        f"shared-prefix windowed serving cannot re-center "
                        f"(unregister the prefix for unbounded budgets)")
        else:
            own_prompt = len(prompt)
            # as _admit: adapter requests do not attend the shared segment
            if images is None and adapter is None \
                    and self._matches_shared(prompt):
                own_prompt -= self.shared_seg["len"]
            if (own_prompt + extra + max_new_tokens + window
                    > self.scfg.max_len):
                raise ValueError(
                    f"prompt ({own_prompt} own-cache tokens) + image embeds "
                    f"({extra}) + max_new_tokens ({max_new_tokens}) exceeds "
                    f"cache length {self.scfg.max_len}")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, images=images, adapter=adapter,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      id=self._next_id)
        self._next_id += 1
        self.pending.append(req)
        trace.instant("serve.submit", request=req.id)
        return req

    @torch.no_grad()
    def register_prefix(self, tokens, share: bool = False) -> None:
        """Prefill ``tokens`` once and keep its K/V (LRU, at most
        ``prefix_cache_size`` entries); text prompts that start with it copy
        it into their slot and prefill only the rest. ``share=True`` makes
        it one broadcast segment every matching slot attends, with no copy
        (one per engine, registered on an idle engine)
        (kosmosx_tpu/serve/admission.py:138-225)."""
        if not share and self.scfg.prefix_cache_size <= 0:
            raise ValueError("ServeConfig.prefix_cache_size is 0")
        toks = _host_ints(tokens)
        if not toks:
            raise ValueError("empty prefix")
        if len(toks) >= self.scfg.max_prompt_len:
            raise ValueError(
                f"prefix len {len(toks)} must be < max_prompt_len "
                f"{self.scfg.max_prompt_len} (a matching prompt needs at "
                f"least one suffix token)")
        if share:
            if self.num_active or self._inflight or self.pending:
                raise ValueError("register_prefix(share=True) requires an "
                                 "idle engine (it re-bases slot positions)")
            if self.cfg.kv_window == 0 and \
                    len(toks) + self.scfg.max_len \
                    > self.cfg.max_target_positions:
                raise ValueError(
                    f"shared prefix ({len(toks)}) + max_len "
                    f"({self.scfg.max_len}) exceeds the learned position "
                    f"table ({self.cfg.max_target_positions}); raise "
                    f"max_positions or shrink max_len")
        key = tuple(toks)
        if not share and key in self.prefix_cache:
            self.prefix_cache.move_to_end(key)
            return
        p = self.scfg.max_prompt_len
        prompt = self._tensor(np.pad(np.asarray(toks, np.int64),
                                     (0, p - len(toks)),
                                     constant_values=self.scfg.pad_id)[None])
        length = self._tensor([len(toks)])

        def prefill(params, cfg, double_scale):
            # the sampled token is discarded: a generator of its own
            gen = torch.Generator(device=self.device).manual_seed(0)
            with self._prefill_span(p, len(toks), cfg):
                return _prefill_one(params, prompt, length, gen, cfg,
                                    self.sampling, self.cache_len,
                                    double_scale=double_scale)[2]

        c1 = prefill(self.dec_params, self.cfg, self.double_scale)
        cd1 = (prefill(self.draft_params, self.draft_cfg, False)
               if self.spec else None)
        if share:
            self.shared_seg = {"key": key, "len": len(toks),
                               "caches": _trim_shared(c1, len(toks),
                                                      self.cfg.dtype)}
            if self.spec:
                # the draft attends its own shared segment
                self.shared_seg["draft_caches"] = _trim_shared(
                    cd1, len(toks), self.draft_cfg.dtype)
            return
        self.prefix_cache[key] = {"caches": c1, "len": len(toks),
                                  "draft": cd1}
        while len(self.prefix_cache) > self.scfg.prefix_cache_size:
            self.prefix_cache.popitem(last=False)

    def load_adapter(self, name: str, lora_tree) -> None:
        """Register a LoRA adapter: requests submitted with ``adapter=name``
        decode through its factors, set per slot into the shared base
        (``nn/layers.linear`` applies per-row factors as two batched
        einsums). ``lora_tree``: the mirror tree of
        ``train/lora.strip_lora`` (kosmosx_tpu/serve/admission.py:227-253)."""
        from kosmosx_torch.train.lora import num_lora_params

        reason = unsupported_reason(
            "adapter", "multimodal" if self.kcfg is not None else None,
            "spec" if self.spec else None)
        if reason is not None:
            raise NotImplementedError(reason)
        tree = _tree_map(lambda t: torch.as_tensor(t).to(self.device),
                         lora_tree)
        if num_lora_params(tree) == 0:
            raise ValueError("lora_tree has no adapter factors")
        if self._slot_lora is None:
            self._init_slot_lora(tree)
        self.adapters[name] = {"tree": tree, "params": self._attach(tree)}

    def _attach(self, lora_tree):
        """The decoder with ``lora_tree``'s factors grafted in (the base's
        tensors shared): a tree, or over a mesh a module marked and cut as
        the engine's decoder (``train/lora.adapted_module``), whose layers
        run their tensor-parallel code on their parts of the factors."""
        from kosmosx_torch.train.lora import adapted_module, attach_lora

        if self.mesh is None:
            return attach_lora(self.dec_params, lora_tree)
        return adapted_module(self.dec_params, lora_tree)

    def _init_slot_lora(self, template):
        """Per-slot factor stacks (slot axis first), zero for every slot,
        and the decode params that read them; ``_set_slot_adapter`` writes
        rows of these tensors in place."""
        b = self.scfg.max_batch
        self._slot_lora = _tree_map(
            lambda t: torch.zeros((b,) + tuple(t.shape), dtype=t.dtype,
                                  device=self.device), template)
        self._zero_adapter = _tree_map(torch.zeros_like, template)
        self._live_params = self._attach(self._slot_lora)

    def _set_slot_adapter(self, slot: int, name: Optional[str]):
        if self._slot_lora is None:
            return
        src = (self.adapters[name]["tree"] if name is not None
               else self._zero_adapter)
        _tree_map(lambda dst, s: dst[slot].copy_(s), self._slot_lora, src)

    def _pool_params(self):
        """Decode params: the base, or base + per-slot adapter stacks once
        an adapter is loaded."""
        return self._live_params if self._live_params is not None \
            else self.dec_params

    def _rows_params(self, slots: torch.Tensor):
        """``_pool_params`` for the pool rows ``slots`` only."""
        if self._slot_lora is None:
            return self.dec_params
        return self._attach(_tree_map(lambda t: t.index_select(0, slots),
                                      self._slot_lora))

    def _row1(self, req: Request):
        """The batch-1 rows tuple of a request's sampling overrides, or
        None."""
        if req.temperature is None and req.top_k is None \
                and req.top_p is None:
            return None
        return (self._tensor([True]),
                self._tensor([1.0 if req.temperature is None
                              else float(req.temperature)], torch.float32),
                self._tensor([0 if req.top_k is None else int(req.top_k)]),
                self._tensor([1.0 if req.top_p is None
                              else float(req.top_p)], torch.float32))

    def _rows(self):
        """Per-slot sampling-override vectors (on, temp, top_k, top_p), or
        None while no occupied slot carries an override."""
        if not any(self._override_host[i]
                   for i, s in enumerate(self.slots) if s is not None):
            return None
        return (self.slot_override, self.slot_temp, self.slot_topk,
                self.slot_topp)

    def _shared(self):
        """(shared_caches, shared_on, pos_offset) for the decode programs."""
        if self.shared_seg is None:
            return None
        return (self.shared_seg["caches"], self.shared_on, self.pos_offset)

    def _shared_d(self):
        """The draft pool's shared segment (speculative engines)."""
        if self.shared_seg is None or "draft_caches" not in self.shared_seg:
            return None
        return (self.shared_seg["draft_caches"], self.shared_on,
                self.pos_offset)

    def _matches_shared(self, toks) -> bool:
        sh = self.shared_seg
        return (sh is not None and len(toks) > sh["len"]
                and [int(t) for t in toks[:sh["len"]]] == list(sh["key"]))

    def _match_prefix(self, praw, probe: bool = False):
        """The longest registered prefix that strictly prefixes ``praw``;
        ``probe=True`` leaves the LRU order and the hit count as they
        are."""
        best = None
        for key in self.prefix_cache:
            n = len(key)
            if n < len(praw) and (best is None or n > best[1]) \
                    and list(praw[:n]) == list(key):
                best = (key, n)
        if best is None:
            return None
        if not probe:
            self.prefix_cache.move_to_end(best[0])
            self.prefix_hits += 1
        return self.prefix_cache[best[0]]

    def warmup(self, images=None, adapters: bool = True) -> int:
        """Run one throwaway request of every admission flavor (each prompt
        bucket, each loaded adapter, a multimodal request when ``images`` is
        given, prefix hits) and one full batched-admission group, then
        reset the counters (kosmosx_tpu/serve/admission.py:356-427). It
        builds nothing on the card (the kernels build at their first call)
        but takes every path once before traffic. Requires an idle engine;
        returns the number of warmup requests."""
        if self.num_active or self._inflight or self.pending:
            raise ValueError("warmup requires an idle engine")
        tok = self.scfg.pad_id + 1
        p = self.scfg.max_prompt_len
        flavors = []
        buckets = [b for b in sorted(self.scfg.prompt_buckets) if b <= p]
        for b in buckets:
            flavors.append({"prompt": [tok] * b})
        # the pad-to-max_prompt_len path: the shortest prompt that misses
        # every bucket, so tight max_len budgets still admit it
        full_len = min(p, (max(buckets) + 1) if buckets else 2)
        flavors.append({"prompt": [tok] * full_len})
        if adapters:
            for name in self.adapters:
                flavors.append({"prompt": [tok] * 2, "adapter": name})
        if images is not None:
            flavors.append({"prompt": [tok] * 2, "images": images})
        for key in list(self.prefix_cache)[:1]:
            flavors.append({"prompt": list(key) + [tok]})
        if self.shared_seg is not None:
            flavors.append({"prompt": list(self.shared_seg["key"]) + [tok]})
        hits_before = self.prefix_hits
        handles = []
        for f in flavors:
            try:
                handles.append(self.submit(max_new_tokens=2, **f))
            except ValueError:
                # a flavor that cannot fit max_len never runs in traffic
                pass
        self.run()
        assert all(h.done for h in handles)
        if self._admit_bucket > 1 and not self.chunked \
                and not self.scfg.prompt_buckets:
            group = []
            for _ in range(self._admit_bucket):
                try:
                    group.append(self.submit([tok, tok], max_new_tokens=2))
                except ValueError:
                    break
            if len(group) < self._admit_bucket:
                warnings.warn(
                    f"warmup could admit {len(group)} of the "
                    f"{self._admit_bucket} requests of a batched admission "
                    f"(max_len {self.scfg.max_len}): the batched-admission "
                    f"path was not taken", RuntimeWarning, stacklevel=2)
            self.run()
            assert all(h.done for h in group)
            handles += group
        self.prefix_hits = hits_before
        self.emitted_total = 0
        self.accepted_total = 0
        self.steps = 0
        return len(handles)

    def cancel(self, req: Request) -> bool:
        """Drop a request from the queue or free its slot; tokens already
        committed stay on ``req.tokens``, tokens in flight are discarded.
        False if it had finished (kosmosx_tpu/serve/admission.py:
        429-446)."""
        if req.done:
            return False
        req.done = True
        try:
            self.pending.remove(req)
        except ValueError:
            pass
        for i, s in enumerate(self.slots):
            if s is req:
                self.slots[i] = None
                if self.chunked:
                    self._pf_pos[i] = -1
        return True

    # -- admission internals -------------------------------------------------

    def _batchable(self, req: Request) -> bool:
        """Eligible for the batched admission: a plain text-only request (no
        images, adapter, chunked ingestion, prompt buckets, sampling
        overrides, prefix-cache or shared-segment hit). The batched
        prefill samples with the engine's SamplingConfig only: an override
        keeps the batch-1 path, which takes per-request rows."""
        if self.chunked or req.images is not None or req.adapter is not None:
            return False
        if self.scfg.prompt_buckets:
            return False
        if req.temperature is not None or req.top_k is not None \
                or req.top_p is not None:
            return False
        if self.shared_seg is not None and self._matches_shared(req.prompt):
            return False
        if self.prefix_cache and \
                self._match_prefix(req.prompt, probe=True) is not None:
            return False
        return True

    def _admit_many(self, pairs) -> None:
        """Admit ``_admit_bucket`` simple text-only requests with one
        prefill of that many rows (kosmosx_tpu/serve/admission.py:468-556).
        ``step`` forms only groups of exactly that size; fewer requests
        admit one by one. The batch commits as one admission entry of the
        drain (throughput engines) or one read (latency engines)."""
        with trace.span("serve.admit_many") as sp:
            if sp.on:
                sp.set(requests=[req.id for _, req in pairs])
            a = len(pairs)
            p = self.scfg.max_prompt_len
            slots = [s for s, _ in pairs]
            prompts = np.full((a, p), self.scfg.pad_id, np.int64)
            lens = np.zeros((a,), np.int64)
            for r, (slot, req) in enumerate(pairs):
                prompts[r, :len(req.prompt)] = req.prompt
                lens[r] = len(req.prompt)
                self._dispatched[slot] = 0
                self._reset_center(slot)
                self._prefill_host[slot] = len(req.prompt)
                self._set_slot_adapter(slot, None)
                self._override_host[slot] = False
            sl = self._tensor(slots)
            self.slot_override[sl] = False
            self.slot_temp[sl] = 1.0
            self.slot_topk[sl] = 0
            self.slot_topp[sl] = 1.0
            if self.shared_seg is not None:
                # no request here matches the segment; a previous occupant
                # may have attended it
                self.shared_on[sl] = False
                self.pos_offset[sl] = 0
            pj, lj = self._tensor(prompts), self._tensor(lens)
            reqs = [req for _, req in pairs]
            real = int(lens.sum())
            with self._prefill_span(p, real, self.cfg, reqs, rows=a):
                first, flp, c_a = _prefill_one(
                    self.dec_params, pj, lj, self.generator, self.cfg,
                    self.sampling, self.cache_len,
                    double_scale=self.double_scale)
            _insert_rows(self.caches, c_a, sl)
            self.index[sl] = lj
            if self.spec:
                with self._prefill_span(p, real, self.draft_cfg, reqs,
                                        rows=a):
                    _, _, cd_a = _prefill_one(
                        self.draft_params, pj, lj, self.generator,
                        self.draft_cfg, self.sampling, self.cache_len)
                _insert_rows(self.draft_caches, cd_a, sl)
                self.index_d[sl] = lj
            if self.scfg.sync_lag > 0 or self.scfg.async_drain:
                self.last[sl] = first
                for slot, req in pairs:
                    self.slots[slot] = req
                    self._dispatched[slot] = 1
                self._inflight.append(
                    self._entry(first, flp, {"slots": slots}))
            else:
                with trace.span("serve.wait", on="tolist"):
                    toks, lps = first.tolist(), flp.tolist()
                for r, (slot, req) in enumerate(pairs):
                    self._commit_first_token(slot, req, toks[r], lps[r])

    def _admit(self, slot: int, req: Request):
        """Admit one request into ``slot``: prefix hits, chunked ingestion,
        bucketed text and multimodal prefills
        (kosmosx_tpu/serve/admission.py:558-727)."""
        with trace.span("serve.admit", request=req.id, slot=slot) as sp:
            self._dispatched[slot] = 0
            self._reset_center(slot)  # fresh caches are prefilled at center 0
            p = self.scfg.max_prompt_len
            praw = list(req.prompt)
            n_img = 0
            if req.images is not None:
                n_img = req.images.shape[0] if req.images.ndim == 4 else 1
            k_img = self.kcfg.image_embed_len if self.kcfg is not None else 0
            self._prefill_host[slot] = len(praw) + n_img * k_img
            s_idx = self.kcfg.splice_index if self.kcfg is not None else 0
            self._set_slot_adapter(slot, req.adapter)
            override = (req.temperature is not None or req.top_k is not None
                        or req.top_p is not None)
            self._override_host[slot] = override
            self.slot_override[slot] = override
            self.slot_temp[slot] = (1.0 if req.temperature is None
                                    else float(req.temperature))
            self.slot_topk[slot] = 0 if req.top_k is None else int(req.top_k)
            self.slot_topp[slot] = (1.0 if req.top_p is None
                                    else float(req.top_p))
            # the shared segment: matching slots attend it, their own cache
            # starts at 0 with positions shifted by its length. Adapter
            # requests skip both prefix paths (prefixes were prefilled by the
            # base).
            sh_match = (req.images is None and req.adapter is None
                        and self._matches_shared(praw))
            if self.shared_seg is not None:
                self.shared_on[slot] = bool(sh_match)
                self.pos_offset[slot] = (self.shared_seg["len"] if sh_match
                                         else 0)
                if sh_match:
                    self.prefix_hits += 1
                    praw = praw[self.shared_seg["len"]:]
            hit = (self._match_prefix(praw)
                   if self.prefix_cache and req.images is None and not sh_match
                   and req.adapter is None else None)
            if self.chunked and (req.images is None or len(praw) > s_idx):
                sp.set(path="chunked")
                # the text streams in chunk by chunk (_advance_prefill)
                self._prompt_rows[slot, :] = self.scfg.pad_id
                self._prompt_rows[slot, :len(praw)] = praw
                self._pf_len[slot] = len(praw)
                if req.images is not None:
                    # the vision tower and the spliced prefix once; the text
                    # remainder joins the chunk stream at s_idx
                    head = s_idx + n_img * k_img
                    with self._prefill_span(head, head, self.cfg, [req]):
                        c1, idx0 = _prefill_mm_prefix(
                            self._kosmos, self._tensor([praw[:s_idx]]),
                            self._images(req.images), self.kcfg,
                            self.cache_len)
                    _insert_slot(self.caches, c1, slot)
                    self._pf_pos[slot] = s_idx
                    self.index[slot] = idx0
                elif hit is not None:
                    _insert_slot(self.caches, hit["caches"], slot)
                    self._pf_pos[slot] = hit["len"]
                    self.index[slot] = hit["len"]
                else:
                    self._pf_pos[slot] = 0
                    self.index[slot] = 0
                self.slots[slot] = req
                return
            if hit is not None or sh_match:
                sp.set(path="prefix")
                self._admit_suffix(slot, req, praw, hit, sh_match)
                return
            # prompt_buckets: pad to the smallest bucket that fits
            pad_to = p
            for bucket in sorted(self.scfg.prompt_buckets):
                if len(praw) <= bucket <= p:
                    pad_to = bucket
                    break
            prompt = self._tensor(
                [praw + [self.scfg.pad_id] * (pad_to - len(praw))])
            length = self._tensor([len(praw)])
            if req.images is not None:
                sp.set(path="multimodal")
                images = n_img * k_img
                with self._prefill_span(pad_to + images, len(praw) + images,
                                        self.cfg, [req]):
                    first, flp, c1, full_len = _prefill_mm_one(
                        self._kosmos, prompt, self._images(req.images), length,
                        self.generator, self.kcfg, self.sampling,
                        self.cache_len, rows=self._row1(req))
                idx = full_len
            else:
                sp.set(path="single")
                pparams = (self.adapters[req.adapter]["params"]
                           if req.adapter is not None else self.dec_params)
                with self._prefill_span(pad_to, len(praw), self.cfg, [req]):
                    first, flp, c1 = _prefill_one(
                        pparams, prompt, length, self.generator, self.cfg,
                        self.sampling, self.cache_len,
                        double_scale=self.double_scale, rows=self._row1(req))
                idx = length
            _insert_slot(self.caches, c1, slot)
            if self.spec:
                # the draft prefills on the tokens only (a multimodal slot's
                # image tags included, its embeddings never), at single scale
                with self._prefill_span(pad_to, len(praw), self.draft_cfg,
                                        [req]):
                    _, _, cd1 = _prefill_one(
                        self.draft_params, prompt, length, self.generator,
                        self.draft_cfg, self.sampling, self.cache_len)
                _insert_slot(self.draft_caches, cd1, slot)
                self.index_d[slot] = len(praw)
            self.index[slot] = idx[0]
            self._commit_first(slot, req, first, flp)

    def _admit_suffix(self, slot: int, req: Request, praw, hit, sh_match):
        """A prefix hit: a batch-1 prefill of the suffix only. Copy mode
        copies the registered K/V into the slot and writes the suffix into
        the slot's row of the pool; share mode starts a fresh
        remainder-only cache that attends the broadcast segment
        (kosmosx_tpu/serve/admission.py:638-683)."""
        suffix = praw[hit["len"]:] if hit is not None else praw
        start = hit["len"] if hit is not None else 0
        pad_to = min(_suffix_bucket(len(suffix), self.scfg.max_prompt_len),
                     self.cache_len - start)
        srow = self._tensor([suffix + [self.scfg.pad_id]
                             * (pad_to - len(suffix))])
        slen = self._tensor([len(suffix)])
        runs = [(self.dec_params, self.cfg, self.caches, "caches",
                 self.double_scale, self._row1(req))]
        if self.spec:
            runs.append((self.draft_params, self.draft_cfg,
                         self.draft_caches, "draft_caches", False, None))
        out = None
        for params, cfg, pool, seg_key, double_scale, rows in runs:
            shared1 = None
            if sh_match:
                shared1 = (self.shared_seg[seg_key], self._tensor([True]),
                           self._tensor([self.shared_seg["len"]]))
                from kosmosx_torch.nn import decoder as dec

                c1 = dec.init_cache(cfg, 1, self.cache_len, device=self.device,
                                    params=params)
            else:
                _insert_slot(pool, hit["caches" if seg_key == "caches"
                                      else "draft"], slot)
                c1 = _slot_view(pool, slot)
            res = _prefill_suffix(params, srow, slen, start, c1,
                                  self.generator, cfg, self.sampling,
                                  double_scale=double_scale, shared=shared1,
                                  rows=rows)
            if sh_match:
                _insert_slot(pool, c1, slot)
            if out is None:
                out = res
        self.index[slot] = start + len(suffix)
        if self.spec:
            self.index_d[slot] = start + len(suffix)
        self._commit_first(slot, req, *out)

    def _commit_first_token(self, slot: int, req: Request, tok: int,
                            lp: float):
        """The host's part of committing an admission's first token."""
        with trace.span("serve.commit", request=req.id, tokens=1):
            self.last[slot] = tok
            self.slots[slot] = req
            req.tokens.append(tok)
            req.logprobs.append(lp)
            self._dispatched[slot] = 1
            self.emitted_total += 1
            self._maybe_finish(slot, tok)

    def _commit_first(self, slot: int, req: Request, first, flp):
        """Commit an admission's sampled first token
        (kosmosx_tpu/serve/admission.py:742-770): throughput engines
        (sync_lag > 0 or async_drain) feed it to the slot on the device and
        bookkeep it through the drain; latency engines read it now."""
        if self.scfg.sync_lag > 0 or self.scfg.async_drain:
            self.last[slot] = first[0]
            self.slots[slot] = req
            self._dispatched[slot] = 1
            self._inflight.append(self._entry(first, flp, {"slot": slot}))
        else:
            with trace.span("serve.wait", on="item"):
                tok, lp = int(first[0]), float(flp[0])
            self._commit_first_token(slot, req, tok, lp)

    def _maybe_finish(self, slot: int, tok: int):
        req = self.slots[slot]
        if req is not None:
            self._finish_if_needed(slot, req, tok)

    def _finish_if_needed(self, slot: int, req: Request, tok: int):
        if ((req.eos_id is not None and tok == req.eos_id)
                or len(req.tokens) >= req.max_new_tokens):
            req.done = True
            # the slot may have been re-admitted while bookkeeping lagged
            if self.slots[slot] is req:
                self.slots[slot] = None

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _is_prefilling(self, slot: int) -> bool:
        return self.chunked and self._pf_pos[slot] >= 0

    def _advance_prefill(self):
        """Ingest one chunk for every ingesting slot; slots whose prompt
        completes sample their first token and start decoding
        (kosmosx_tpu/serve/admission.py:799-844)."""
        k = self.scfg.prefill_chunk
        slots = [s for s in range(self.scfg.max_batch) if self._pf_pos[s] >= 0]
        a = len(slots)
        chunk = np.full((a, k), self.scfg.pad_id, np.int64)
        seg = np.full((a, k), -1, np.int64)
        boundary = np.zeros((a,), np.int64)
        completing = []
        for r, slot in enumerate(slots):
            pos, plen = self._pf_pos[slot], self._pf_len[slot]
            n = min(k, plen - pos)
            chunk[r, :n] = self._prompt_rows[slot, pos:pos + n]
            seg[r, :n] = 0
            boundary[r] = n - 1
            if pos + n >= plen:
                completing.append(r)
        st = self._tensor(slots)
        rows = self._rows()
        shared = self._shared()
        if shared is not None:
            shared = (shared[0], shared[1][st], shared[2][st])
        first, flp, self.index = _prefill_chunk_pool(
            self._rows_params(st), self._tensor(chunk),
            self._tensor(seg).to(torch.int32), self.caches, self.index, st,
            self._tensor(boundary), self.generator, self.cfg, self.sampling,
            double_scale=self.double_scale, shared=shared,
            rows=None if rows is None else tuple(v[st] for v in rows))
        if completing:
            with trace.span("serve.wait", on="tolist"):
                toks, lps = first.tolist(), flp.tolist()   # one read
            for r in completing:
                slot = slots[r]
                req = self.slots[slot]
                self.last[slot] = toks[r]
                self._pf_pos[slot] = -1
                if req is not None:
                    with trace.span("serve.commit", request=req.id, tokens=1):
                        req.tokens.append(toks[r])
                        req.logprobs.append(lps[r])
                        self._dispatched[slot] = 1
                        self.emitted_total += 1
                        self._finish_if_needed(slot, req, toks[r])
        for slot in slots:
            if self._pf_pos[slot] >= 0:
                self._pf_pos[slot] += k

    # -- host <-> device -----------------------------------------------------

    def _tensor(self, data, dtype=None) -> torch.Tensor:
        """Host data on the engine's device; on the card through pinned
        memory with ``non_blocking=True``, so no copy waits for the
        device's queue."""
        with trace.span("serve.copy", to="device") as sp:
            t = torch.as_tensor(np.asarray(data))
            if dtype is not None:
                t = t.to(dtype)
            if sp.on:
                sp.set(bytes=t.numel() * t.element_size())
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.clone()

    def _images(self, images) -> torch.Tensor:
        """A request's image(s), (M, 3, H, W) or (3, H, W), as a batch-1
        float tensor on the device."""
        with trace.span("serve.copy", to="device", what="images") as sp:
            t = torch.as_tensor(images).float()
            if sp.on:
                sp.set(bytes=t.numel() * t.element_size())
            return (t if t.ndim == 5 else t[None]).to(self.device)

    def _prefill_span(self, width: int, real: int, cfg, reqs=(),
                      rows: int = 1):
        """Count a whole-prompt prefill of ``rows`` rows padded to ``width``
        positions (cut to the cache length), ``real`` of them the prompts'
        tokens and image embeddings, and return its ``serve.prefill`` span
        (``width`` and ``layers``: at 256 positions or more each layer
        launches the flash kernel)."""
        width = min(int(width), self.cache_len)
        computed = width * rows
        real = min(int(real), computed)
        self.prefills += 1
        self.prefill_positions += computed
        self.prefill_padded += computed - real
        sp = trace.span("serve.prefill")
        if sp.on:
            sp.set(width=width, real=real, padded=computed - real,
                   layers=cfg.layers)
            if rows == 1 and len(reqs) == 1:
                sp.set(request=reqs[0].id)
            elif reqs:
                sp.set(requests=[r.id for r in reqs])
        return sp

    def _entry(self, toks, lps, counts: Any):
        """An inflight entry: the host copies of a dispatch's tokens and
        log-probs (their copy started now), what they count, the slot
        occupancy at dispatch, and the event a drain waits on."""
        toks_h, event = self._to_host(toks)
        lps_h, event = self._to_host(lps, event)
        if isinstance(counts, torch.Tensor):
            counts, event = self._to_host(counts, event)
        if event is not None:
            event.record()
        return (toks_h, lps_h, counts, list(self.slots), event)
