"""Continuous-batching serving engine over a slot pool of KV caches
(counterpart of kosmosx_tpu/serve/engine.py).

A pool of ``max_batch`` slots over one per-layer KV cache; each
``step()`` admits pending requests into free slots (simple text-only ones
eight at a time in one prefill), then advances every active slot one token
(or one block, or one speculative round) in one batched decode, and reads
tokens back ``sync_lag`` steps behind the device. The decode feedback loop
never leaves the device: ``last``, ``index``, the active mask and the
per-slot sampling vectors live there. Each dispatch starts the copy of its
tokens and log-probs into pinned host memory and records a CUDA event; the
drains (inline, or a reader thread under ``async_drain``) wait on those
events, and no other part of ``step()`` reads the device. Host-kept
schedules (``_dispatched``, ``_prefill_host``, ``_center_host``) decide
the budget clamp and re-centering without a device read.

On the card an admission prefill of 256 or more positions runs the flash
kernel, and with ``decode_attn_kernel=True`` every decode step runs the
decode kernel over the pool (not under a shared prefix, which plain
attention serves); W8 parameters run the W8 kernels.

Layout: serve/config.py (ServeConfig, Request, the mode matrix),
serve/programs.py (the device programs), serve/admission.py (submit,
prefixes, adapters, chunked ingestion), this file (the loop).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from time import perf_counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kosmosx_torch.core.config import KosmosConfig, MagnetoConfig
from kosmosx_torch.generate.sampler import SamplingConfig
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.serve.admission import AdmissionMixin
from kosmosx_torch.serve.config import (Request, ServeConfig,
                                        check_engine_modes)
from kosmosx_torch.serve.programs import (_decode_block, _decode_core,
                                          _recenter_pool, _spec_block_pool,
                                          _spec_core)
from kosmosx_torch.utils import trace

__all__ = ["ServeConfig", "Request", "ServeEngine"]


def _stop_reader(q, thread) -> None:
    q.put(None)
    thread.join(timeout=60)


def _place(params, mesh) -> None:
    """Cut a whole model over ``mesh``'s ``tensor`` and ``expert`` dims in
    place (a model cut already is left as it is)."""
    from torch.distributed.tensor import DTensor

    from kosmosx_torch.parallel import tensor as tpar

    if not isinstance(params, torch.nn.Module):
        raise ValueError("ServeEngine(mesh=) takes a parameter-tree module "
                         "(KosmosLanguage, Kosmos)")
    if any(isinstance(p, DTensor) for p in params.parameters()):
        raise ValueError("ServeEngine(mesh=) keeps no ZeRO shards: pass the "
                         "whole parameters (train/checkpoint.restore_params "
                         "into a model built on every rank)")
    if tpar.axes(params) == (None, None):
        tpar.shard_model(params, mesh)


class ServeEngine(AdmissionMixin):
    """Continuous-batching engine over one model.

    >>> eng = ServeEngine(model, cfg, ServeConfig(max_batch=4))
    >>> h = eng.submit([3, 17, 9], max_new_tokens=16, eos_id=2)
    >>> eng.run()          # drain every pending and in-flight request
    >>> h.tokens           # generated ids (stops at eos_id if hit)

    ``params`` is a ``KosmosLanguage`` or a ``Kosmos`` (with ``kosmos_cfg``:
    requests may then carry images), or their parameter trees, on
    ``device`` (None: the card). ``generator``: a ``torch.Generator`` on
    that device for sampling (default seeded 0).

    ``mesh`` (``parallel.mesh.make_mesh``): tensor-parallel serving. The
    decoder layers of ``params`` (a module, whole or cut already) are cut
    in place over the mesh's ``tensor`` dim (``parallel/tensor.
    shard_model``), so the KV pool holds ``heads / tp`` heads a rank
    (int8 scales with their heads), and prefill and decode run the
    tensor-parallel layers. Every rank runs the same engine over the same
    requests with a generator seeded alike, so the ranks give the same
    tokens; its drains are synchronous (``async_drain`` off: the reader
    thread's timing would let the ranks' schedules part). Ranks that
    differ only in ``data`` or ``fsdp`` are replicas:
    the engine keeps no ZeRO shards (pass whole parameters, not an FSDP
    model). W8 weights are cut by their float weights' rule, and each
    rank's W8 kernels run on its cut of the codes; adapters
    (``load_adapter``) stay whole, and each rank applies its part of every
    slot's factors.
    """

    def __init__(self, params, cfg: MagnetoConfig,
                 serve_cfg: Optional[ServeConfig] = None,
                 sampling: Optional[SamplingConfig] = None,
                 kosmos_cfg: Optional[KosmosConfig] = None,
                 generator: Optional[torch.Generator] = None,
                 draft_params=None, draft_cfg: Optional[MagnetoConfig] = None,
                 device=None, mesh=None):
        scfg = serve_cfg or ServeConfig()
        if mesh is not None:
            _place(params, mesh)
            # the reader thread's timing would let the ranks' schedules part:
            # drains wait in step order
            scfg = dataclasses.replace(scfg, async_drain=False)
        self.mesh = mesh
        sampling = sampling or SamplingConfig(greedy=True)
        self.spec = scfg.spec_gamma > 0
        if self.spec and (draft_params is None or draft_cfg is None):
            raise ValueError("spec_gamma > 0 needs draft_params and "
                             "draft_cfg")
        check_engine_modes(cfg, scfg, draft_cfg=draft_cfg,
                           kosmos_cfg=kosmos_cfg,
                           sampling=sampling if self.spec else None)
        if scfg.unroll_min_len is not None:
            # accepted for JAX's flags; the pool is always per-layer
            cfg = dataclasses.replace(
                cfg, decode_unroll_min_len=scfg.unroll_min_len)
            if draft_cfg is not None:
                draft_cfg = dataclasses.replace(
                    draft_cfg, decode_unroll_min_len=scfg.unroll_min_len)
        self.device = torch.device("cuda" if device is None else device)
        self.cfg = cfg
        self.kcfg = kosmos_cfg
        self.dec_params = params["decoder"] if kosmos_cfg is not None \
            else params
        self._kosmos = None
        if kosmos_cfg is not None:
            from kosmosx_torch.models.kosmos import Kosmos

            self._kosmos = params if isinstance(params, Kosmos) else \
                Kosmos(kosmos_cfg, params=params)
        table = self.dec_params["embed"]["table"]
        table = table["q"] if isinstance(table, (dict, torch.nn.Module)) \
            and "q" in table else table
        if table.device.type != self.device.type:
            raise ValueError(f"the parameters lie on {table.device}, the "
                             f"engine runs on {self.device}")
        self.scfg = scfg
        self.sampling = sampling
        self.double_scale = bool(kosmos_cfg.parity_double_scale) \
            if kosmos_cfg is not None else False
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        elif generator.device.type != self.device.type:
            raise ValueError(f"the generator lies on {generator.device}, the "
                             f"engine runs on {self.device}")
        # every device program draws from this one generator. JAX folds a
        # fresh key per call on the host (kosmosx_tpu/serve/engine.py:
        # 241-259); one generator that advances with every draw is as
        # deterministic given its seed and the call order
        self.generator = generator
        b = scfg.max_batch
        # with kv_window the ring bounds the cache
        self.cache_len = (min(scfg.max_len, cfg.kv_window)
                          if cfg.kv_window > 0 else scfg.max_len)
        self.caches = dec.init_cache(cfg, b, self.cache_len, device=self.device,
                                     params=self.dec_params)
        self.index = torch.zeros((b,), dtype=torch.long, device=self.device)
        self.last = torch.full((b,), scfg.pad_id, dtype=torch.long,
                               device=self.device)
        self.slots: List[Optional[Request]] = [None] * b
        self.pending: deque = deque()
        self._inflight: deque = deque()  # see AdmissionMixin._entry
        self._dispatched = [0] * b       # tokens dispatched per slot
        self._prefill_host = [0] * b     # prefill length (tokens + embeds)
        self._active_key = None          # active list at the last rebuild
        self._active_dev = None          # its device copy
        self._next_id = 0
        self.steps = 0
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        if self.spec:
            self.draft_caches = dec.init_cache(
                draft_cfg, b, self.cache_len, device=self.device,
                params=draft_params)
            # the draft's own index: the target's for text slots, less the
            # image embeds for multimodal slots
            self.index_d = torch.zeros_like(self.index)
        self.accepted_total = 0
        self.emitted_total = 0
        self.prefix_cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self.prefix_hits = 0
        self.shared_seg = None
        self.pos_offset = torch.zeros_like(self.index)
        self.shared_on = torch.zeros((b,), dtype=torch.bool,
                                     device=self.device)
        # rolling-window xPos re-centering, off while a shared segment is
        # registered (its keys sit at center 0 for every slot)
        self._center = torch.zeros_like(self.index) \
            if cfg.kv_window > 0 and cfg.xpos_rel_pos else None
        self._center_host = [0] * b
        # per-request sampling overrides (rows flagged in slot_override
        # replace the engine's SamplingConfig)
        self.slot_override = torch.zeros((b,), dtype=torch.bool,
                                         device=self.device)
        self.slot_temp = torch.ones((b,), device=self.device)
        self.slot_topk = torch.zeros_like(self.index)
        self.slot_topp = torch.ones((b,), device=self.device)
        self._override_host = [False] * b
        # multi-LoRA serving (load_adapter / submit(adapter=...))
        self.adapters: Dict[str, Any] = {}
        self._slot_lora = None
        self._zero_adapter = None
        self._live_params = None
        self.block = max(int(scfg.decode_block), 0)
        # batched admission: groups of exactly this many simple text-only
        # requests prefill together; smaller groups admit one by one
        self._admit_bucket = min(b, 8)
        # ServeConfig.decode_kernel_fill's alternate config
        self._cfg_kernel = (dataclasses.replace(cfg, decode_attn_kernel=True)
                            if scfg.decode_kernel_fill > 0 else None)
        self.chunked = scfg.prefill_chunk > 0
        # async drains: the reader thread and its queues, made at first use
        self._reader = None
        self._reader_q = None
        self._done_q = None
        self._outstanding = 0
        # host-loop anatomy: wall seconds per step() phase
        self.phase_s = {k: 0.0 for k in
                        ("admit", "prep", "dispatch", "post", "drain")}
        # whole-prompt prefills: programs run, positions computed (padding
        # included) and padding among them; each prefill's own numbers are
        # its serve.prefill span's
        self.prefills = self.prefill_positions = self.prefill_padded = 0
        if self.chunked:
            self._prompt_rows = np.full((b, scfg.max_prompt_len),
                                        scfg.pad_id, np.int64)
            self._pf_pos = [-1] * b    # -1: not ingesting
            self._pf_len = [0] * b

    # -- internals -----------------------------------------------------------

    def _reset_center(self, slot: int):
        """A freshly admitted slot's cache is prefilled at xPos center 0."""
        if self._center is not None and self._center_host[slot] != 0:
            self._center_host[slot] = 0
            self._center[slot] = 0

    def _maybe_recenter(self, active_list):
        """Slide due slots' xPos centers forward (rolling-window serving,
        kosmosx_tpu/serve/engine.py:267-298): a slot's write position is
        ``_prefill_host + _dispatched``, both known on the host."""
        if self._center is None or self.shared_seg is not None:
            return
        every = 8 * self.cfg.xpos_scale_base
        pos = [p + d for p, d in zip(self._prefill_host, self._dispatched)]
        due = [a and pos[i] - self._center_host[i] >= every
               for i, a in enumerate(active_list)]
        if not any(due):
            return
        slack = self.cfg.kv_window + every + max(self.block, 1) - 1
        for i, d in enumerate(due):
            if d:
                assert pos[i] - self._center_host[i] <= slack, \
                    (pos[i], self._center_host[i], self.cfg.kv_window, every)
        new = [pos[i] if d else self._center_host[i]
               for i, d in enumerate(due)]
        delta = self._tensor([n - c for n, c in zip(new, self._center_host)])
        _recenter_pool(self.caches, delta, self.cfg)
        self._center_host = new
        self._center = self._tensor(new)

    def _decode_cfg(self, active_list):
        """``ServeConfig.decode_kernel_fill``: the ``decode_attn_kernel``
        variant for a dispatch whose active slots fill at most that share
        of a pool of 1024 positions or more, by the host-known fill, as
        JAX picks it (kosmosx_tpu/serve/engine.py:332-351). The TPU
        finding behind the rule (the Pallas kernel wins only at low fill)
        does not hold on the H100, where the kernel beats SDPA at full
        fill too; set ``decode_attn_kernel=True`` on ``cfg`` to take it at
        every dispatch."""
        if (self._cfg_kernel is None or self.shared_seg is not None
                or self.cache_len < 1024):
            return self.cfg
        pos = [min(self._prefill_host[i] + self._dispatched[i],
                   self.cache_len)
               for i, a in enumerate(active_list) if a]
        if not pos or (sum(pos) / (len(pos) * self.cache_len)
                       > self.scfg.decode_kernel_fill):
            return self.cfg
        return self._cfg_kernel

    def _to_host(self, t: torch.Tensor, event=None):
        """Start ``t``'s copy into host memory: pinned and non-blocking on
        the card, with the event a drain waits on; a clone on the CPU."""
        with trace.span("serve.copy", to="host") as sp:
            if sp.on:
                sp.set(bytes=t.numel() * t.element_size())
            if self.device.type != "cuda":
                return t.clone(), None
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host, event or torch.cuda.Event()

    # -- the decode loop -----------------------------------------------------

    @torch.no_grad()
    def step(self) -> bool:
        """Admit pending requests into free slots, advance every active slot,
        read back tokens ``sync_lag`` steps behind the device
        (kosmosx_tpu/serve/engine.py:355-537). False when nothing is left
        to do."""
        with trace.span("serve.step") as sp:
            if sp.on:
                sp.set(step=self.steps, active=self.num_active,
                      pending=len(self.pending))
            return self._step()

    def _step(self) -> bool:
        t0 = perf_counter()
        batch_pairs = []
        for slot in range(self.scfg.max_batch):
            if self.slots[slot] is None and self.pending:
                req = self.pending.popleft()
                if self._batchable(req):
                    batch_pairs.append((slot, req))
                else:
                    self._admit(slot, req)
        bsz = self._admit_bucket
        while bsz > 1 and len(batch_pairs) >= bsz:
            group, batch_pairs = batch_pairs[:bsz], batch_pairs[bsz:]
            self._admit_many(group)
        for slot_req in batch_pairs:
            self._admit(*slot_req)
        if self.chunked and any(p >= 0 for p in self._pf_pos):
            self._advance_prefill()
        t1 = perf_counter()
        self.phase_s["admit"] += t1 - t0
        # budget clamp: a slot that has dispatched its budget leaves the
        # active mask at once; only EOS waits for the drain (speculation
        # commits a variable count and keeps the drain-time check)
        active_list = [
            s is not None and not self._is_prefilling(i)
            and (self.spec or self._dispatched[i] < s.max_new_tokens)
            for i, s in enumerate(self.slots)]
        act = any(active_list)
        if not act:
            t2 = perf_counter()
            self.phase_s["prep"] += t2 - t1
            t1 = t2
        else:
            self._maybe_recenter(active_list)
            key = tuple(active_list)
            if self._active_dev is None or key != self._active_key:
                self._active_dev = self._tensor(active_list)
                self._active_key = key
            active = self._active_dev
            t2 = perf_counter()
            self.phase_s["prep"] += t2 - t1
            gen = self.generator
            t1 = perf_counter()
            with trace.span("serve.dispatch") as sp:
                if sp.on:
                    sp.set(active=sum(active_list), positions=sum(
                        self._prefill_host[i] + self._dispatched[i]
                        for i, a in enumerate(active_list) if a))
                emit, emit_lp, n_emit = self._dispatch(active, active_list,
                                                       gen)
            self.steps += 1
            t2 = perf_counter()
            self.phase_s["dispatch"] += t2 - t1
            t1 = t2
            with trace.span("serve.post"):
                if not self.spec:
                    for i, n in enumerate(n_emit):
                        self._dispatched[i] += n
                self._inflight.append(self._entry(emit, emit_lp, n_emit))
            t2 = perf_counter()
            self.phase_s["post"] += t2 - t1
            t1 = t2
        with trace.span("serve.drain"):
            self._drain(act)
        self.phase_s["drain"] += perf_counter() - t1
        return (self.num_active > 0 or bool(self.pending)
                or bool(self._inflight) or self._outstanding > 0)

    def _drain(self, act: bool) -> None:
        """Bookkeep what the device has finished: the entries due by
        ``sync_lag`` (all of them when nothing was dispatched)."""
        kb = max(self.scfg.drain_batch, 1)
        if self.scfg.async_drain:
            # hand due entries to the reader in drain_batch batches; block
            # only past the backpressure cap (ServeConfig.overrun_window)
            if act:
                while len(self._inflight) >= self.scfg.sync_lag + kb:
                    self._submit_fetch(
                        [self._inflight.popleft() for _ in range(kb)])
                self._collect_done(max(
                    0, self.scfg.sync_lag + 3 * kb - len(self._inflight)))
            else:
                if self._inflight:
                    self._submit_fetch(list(self._inflight))
                    self._inflight.clear()
                self._collect_done(0)
        elif act:
            while len(self._inflight) >= self.scfg.sync_lag + kb:
                self._drain_many(kb)
        elif self._inflight:
            self._drain_many(len(self._inflight))

    def _dispatch(self, active, active_list, gen):
        """The step's device program: a speculative round or block, a
        decode block or one decode step over the pool. Returns (tokens,
        log-probs, counts): counts a host list, or the spec rounds' device
        counts."""
        if self.spec:
            args = (self.dec_params, self.draft_params, self.last,
                    self.caches, self.draft_caches, self.index, self.index_d,
                    active, gen, self.cfg, self.draft_cfg, self.sampling,
                    self.scfg.spec_gamma)
            kw = dict(pad_id=self.scfg.pad_id, double_scale=self.double_scale,
                      shared_t=self._shared(), shared_d=self._shared_d())
            if self.block > 1:
                emit, emit_lp, n_emit, self.last, self.index, self.index_d = \
                    _spec_block_pool(*args, self.block, **kw)
            else:
                emit, emit_lp, n_emit, self.last, self.index, self.index_d = \
                    _spec_core(*args, **kw)
            return emit, emit_lp, n_emit
        args = (self._pool_params(), self.last, self.caches, self.index,
                active, gen, self._decode_cfg(active_list), self.sampling)
        kw = dict(pad_id=self.scfg.pad_id, double_scale=self.double_scale,
                  shared=self._shared(), rows=self._rows(),
                  center=self._center)
        if self.block > 1:
            emit, emit_lp, self.last, self.index = _decode_block(
                *args, self.block, **kw)
            return emit, emit_lp, [self.block if a else 0
                                   for a in active_list]
        nxt, nlp, self.index = _decode_core(*args, **kw)
        self.last = nxt
        return nxt[:, None], nlp[:, None], [1 if a else 0
                                            for a in active_list]

    def _ensure_reader(self):
        """Start the reader thread (at first use): it only waits on the
        entries' events; bookkeeping stays on the main thread, in dispatch
        order (kosmosx_tpu/serve/engine.py:539-585)."""
        if self._reader is not None:
            return
        import queue
        import threading
        import weakref

        self._reader_q = queue.Queue()
        self._done_q = queue.Queue()

        def _loop(q_in, q_out):
            while True:
                batch = q_in.get()
                if batch is None:
                    return
                try:
                    with trace.span("serve.reader_wait", entries=len(batch)):
                        for entry in batch:
                            if entry[4] is not None:
                                entry[4].synchronize()   # releases the GIL
                    for entry in batch:
                        q_out.put((entry, None))
                except Exception as e:   # surfaced on the main thread
                    for entry in batch:
                        q_out.put((entry, e))

        self._reader = threading.Thread(
            target=_loop, args=(self._reader_q, self._done_q), daemon=True)
        self._reader.start()
        # stop and join the reader when the engine is collected or, at the
        # latest, at exit, before the interpreter tears down
        weakref.finalize(self, _stop_reader, self._reader_q, self._reader)

    def _submit_fetch(self, batch):
        """Hand a list of inflight entries to the reader."""
        self._ensure_reader()
        self._reader_q.put(batch)
        self._outstanding += len(batch)

    def _collect_done(self, max_left: int):
        """Bookkeep what the reader finished, then block until at most
        ``max_left`` entries remain outstanding."""
        import queue as _q

        while self._outstanding > 0:
            block = self._outstanding > max_left
            try:
                with trace.span("serve.wait", on="reader") if block \
                        else trace.OFF:
                    entry, err = self._done_q.get(
                        block=block, timeout=600 if block else None)
            except _q.Empty:
                if block:
                    raise RuntimeError("async-drain reader stalled (600 s)")
                break
            self._outstanding -= 1
            if err is not None:
                raise err
            self._bookkeep(*entry[:4])

    def _drain_many(self, n: int):
        """Wait for the oldest ``n`` entries' copies and bookkeep each
        against the slot occupancy at its dispatch."""
        entries = [self._inflight.popleft() for _ in range(n)]
        for entry in entries:
            if entry[4] is not None:
                with trace.span("serve.wait", on="event"):
                    entry[4].synchronize()
        for entry in entries:
            self._bookkeep(*entry[:4])

    def _bookkeep(self, toks, lps, counts, snapshot):
        """Commit a drained entry's tokens (kosmosx_tpu/serve/engine.py:
        633-671): host tensors only. One ``serve.commit`` span an entry:
        the requests that got tokens and how many each got."""
        with trace.span("serve.commit") as sp:
            got = {} if sp.on else None
            self._commit_entry(toks.tolist(), lps.tolist(), counts, snapshot,
                               got)
            if sp.on:
                sp.set(requests=list(got), tokens=list(got.values()))

    def _commit_entry(self, toks, lps, counts, snapshot, got):
        """``_bookkeep``'s commits; ``got`` (a dict, or None) collects each
        request's count by id."""
        if isinstance(counts, dict):   # an admission's first tokens
            slots = counts.get("slots", None)
            if slots is None:
                slots = [counts["slot"]]
            for r, slot in enumerate(slots):
                req = snapshot[slot]
                if req is not None and not req.done:
                    req.tokens.append(toks[r])
                    req.logprobs.append(lps[r])
                    self.emitted_total += 1
                    if got is not None:
                        got[req.id] = got.get(req.id, 0) + 1
                    self._finish_if_needed(slot, req, toks[r])
            return
        if isinstance(counts, torch.Tensor):
            counts = counts.tolist()
        if isinstance(counts[0], list):   # blocked spec: (K, B, g+1)
            rounds = list(zip(toks, lps, counts))
        else:
            rounds = [(toks, lps, counts)]
        for rtoks, rlps, rcounts in rounds:
            for slot, req in enumerate(snapshot):
                if req is None or req.done:
                    continue
                committed = 0
                for j in range(rcounts[slot]):
                    if req.done or len(req.tokens) >= req.max_new_tokens:
                        break  # lag overrun past the budget or EOS
                    tok = rtoks[slot][j]
                    req.tokens.append(tok)
                    req.logprobs.append(rlps[slot][j])
                    self.emitted_total += 1
                    committed += 1
                    self._finish_if_needed(slot, req, tok)
                if got is not None and committed:
                    got[req.id] = got.get(req.id, 0) + committed
                if self.spec and committed > 0:
                    self.accepted_total += committed - 1

    def reset_counters(self):
        """Zero the host-loop anatomy timers (in place) and the prefill
        counters."""
        for k in self.phase_s:
            self.phase_s[k] = 0.0
        self.prefills = self.prefill_positions = self.prefill_padded = 0

    def run(self, max_steps: Optional[int] = None):
        """Drain every pending and in-flight request (at most
        ``max_steps`` steps)."""
        n = 0
        while (self.pending or self.num_active or self._inflight
               or self._outstanding > 0) and (
                max_steps is None or n < max_steps):
            self.step()
            n += 1
        return n
