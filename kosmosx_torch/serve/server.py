"""HTTP server over the continuous-batching engine
(counterpart of kosmosx_tpu/serve/server.py), standard library only.

- ``POST /v1/completions``: submit a prompt (token ids, or text when the
  server has a tokenizer). A plain request blocks until it finishes;
  ``"stream": true`` answers with NDJSON chunks as tokens are committed
  (one JSON object per flush, the last ``{"done": true, ...}``).
- ``POST /v1/cancel``: ``{"id": n}`` cancels a live request.
- ``GET /healthz``: liveness.
- ``GET /v1/stats``: engine counters (steps, emitted and accepted totals,
  active slots, queue depth, prefix hits), the host loop's seconds per
  phase (``phase_s``), the prefill counters (prefills, positions computed,
  padding among them) and the span buffer's drop count
  (``utils/trace.py``).
- ``start()`` runs ``engine.warmup()`` first (``warmup=False`` skips it),
  so every admission path has run once before traffic.

Threading: the engine is single-threaded (one device, one dispatch loop),
so every engine call happens on one dispatcher thread. HTTP handler threads
talk to it through queues: a submission queue in, a token queue per
request out. The dispatcher idles on the submission queue when the engine
has no work.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional

from kosmosx_torch.utils import trace

logger = logging.getLogger(__name__)


@dataclass
class _Ticket:
    """Handler<->dispatcher handshake for one request."""
    payload: dict
    admitted: threading.Event = field(default_factory=threading.Event)
    done: threading.Event = field(default_factory=threading.Event)
    chunks: "queue.Queue[Optional[List[int]]]" = field(
        default_factory=queue.Queue)
    request: Any = None          # serve.engine.Request once admitted
    error: Optional[str] = None
    sent: int = 0                # tokens already pushed to ``chunks``
    text_out: str = ""           # decoded text already streamed


class ServeServer:
    """HTTP front-end owning a ``ServeEngine`` and its dispatcher thread.

    >>> srv = ServeServer(engine, port=8000)
    >>> srv.start()            # returns; serve_forever runs in threads
    >>> ...                    # POST /v1/completions
    >>> srv.stop()

    ``tokenizer``: optional object with ``encode(str) -> list[int]`` and
    ``decode(list[int]) -> str`` — enables string prompts and a ``"text"``
    field in responses.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 tokenizer=None, default_max_tokens: int = 64,
                 request_timeout: float = 600.0, warmup: bool = True,
                 warmup_images=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.default_max_tokens = default_max_tokens
        self.request_timeout = request_timeout
        self.warmup = warmup
        self.warmup_images = warmup_images
        self._subq: "queue.Queue[_Ticket]" = queue.Queue()
        self._cancelq: "queue.Queue[_Ticket]" = queue.Queue()
        self._by_id: dict = {}        # request id -> ticket (live requests)
        self._tracked: List[_Ticket] = []
        self._running = False
        self._dispatcher: Optional[threading.Thread] = None
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self):
        return self._httpd.server_address  # (host, port) — port resolves 0

    def start(self):
        if self.warmup:
            # every admission path once before traffic
            import time as _time
            t0 = _time.perf_counter()
            n = self.engine.warmup(images=self.warmup_images)
            logger.info("warmup: %d requests in %.1fs", n,
                        _time.perf_counter() - t0)
        self._running = True
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="serve-dispatcher",
                                            daemon=True)
        self._dispatcher.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._http_thread.start()
        logger.info("serving on http://%s:%d", *self.address)
        return self

    def stop(self):
        self._running = False
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=10)

    # -- dispatcher thread (the ONLY thread that touches the engine) ---------

    def _admit_ticket(self, t: _Ticket):
        p = t.payload
        prompt = p.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt needs a server tokenizer; "
                                 "send token ids")
            prompt = self.tokenizer.encode(prompt)
        if not isinstance(prompt, (list, tuple)) or not prompt:
            raise ValueError("prompt must be a non-empty token-id list "
                             "or string")
        t.request = self.engine.submit(
            [int(x) for x in prompt],
            max_new_tokens=int(p.get("max_tokens", self.default_max_tokens)),
            eos_id=p.get("eos_id"), adapter=p.get("adapter"),
            temperature=p.get("temperature"), top_k=p.get("top_k"),
            top_p=p.get("top_p"))

    def _dispatch_loop(self):
        eng = self.engine
        while self._running:
            busy = bool(eng.pending or eng.num_active or eng._inflight
                        or eng._outstanding > 0)
            # admit everything queued; block briefly only when idle
            while True:
                try:
                    t = self._subq.get_nowait() if busy else \
                        self._subq.get(timeout=0.05)
                except queue.Empty:
                    break
                try:
                    self._admit_ticket(t)
                    self._tracked.append(t)
                    self._by_id[t.request.id] = t
                except Exception as e:  # bad payload: fail just this ticket
                    t.error = str(e)
                    t.done.set()
                finally:
                    t.admitted.set()
                busy = True
            # cancellations (client disconnects, POST /v1/cancel) — engine
            # calls stay on this thread
            while True:
                try:
                    t = self._cancelq.get_nowait()
                except queue.Empty:
                    break
                if t.request is not None:
                    eng.cancel(t.request)
                t.chunks.put(None)
                t.done.set()
            if not busy:
                continue
            try:
                eng.step()
            except Exception:
                logger.exception("engine step failed; failing in-flight "
                                 "requests")
                for t in self._tracked:
                    t.error = "engine failure"
                    if t.request is not None:
                        eng.cancel(t.request)  # reclaim the slot
                        self._by_id.pop(t.request.id, None)
                    t.chunks.put(None)
                    t.done.set()
                self._tracked.clear()
                continue
            self._publish()
        # drain: fail anything still queued at shutdown
        while True:
            try:
                t = self._subq.get_nowait()
            except queue.Empty:
                break
            t.error = "server shutting down"
            t.admitted.set()
            t.done.set()

    def _publish(self):
        still = []
        for t in self._tracked:
            req = t.request
            new = req.tokens[t.sent:]
            if new:
                start = t.sent
                t.sent = len(req.tokens)
                item = {"tokens": list(new)}
                if t.payload.get("logprobs"):
                    item["logprobs"] = list(req.logprobs[start:t.sent])
                if self.tokenizer is not None:
                    # Incremental detokenization. Deliberately re-decodes the
                    # full prefix each flush (decode of a token SUFFIX is not
                    # boundary-safe for BPE merges/leading-space rules; a full
                    # decode is ~µs per KB on fast tokenizers). ALL trailing
                    # replacement chars are held back — a multi-byte char
                    # split across byte-fallback tokens decodes to 1..3 of
                    # them until complete — and a delta is emitted only while
                    # the already-streamed prefix is stable, so concatenated
                    # deltas always equal the final text.
                    try:
                        text = self.tokenizer.decode(req.tokens)
                        while text.endswith("�"):
                            text = text[:-1]
                        if text.startswith(t.text_out) and \
                                len(text) > len(t.text_out):
                            item["text"] = text[len(t.text_out):]
                            t.text_out = text
                    except Exception:
                        pass
                t.chunks.put(item)
            if req.done:
                t.chunks.put(None)   # stream sentinel
                t.done.set()
                self._by_id.pop(req.id, None)
            else:
                still.append(t)
        self._tracked = still

    # -- HTTP ----------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._json(200, {"ok": True})
                if self.path == "/v1/stats":
                    eng = server.engine
                    return self._json(200, {
                        "steps": eng.steps,
                        "emitted_total": eng.emitted_total,
                        "accepted_total": eng.accepted_total,
                        "active_slots": eng.num_active,
                        "pending": len(eng.pending),
                        "max_batch": eng.scfg.max_batch,
                        "speculative": eng.spec,
                        "prefix_hits": eng.prefix_hits,
                        "registered_prefixes": len(eng.prefix_cache),
                        "shared_prefix_len": (eng.shared_seg["len"]
                                              if eng.shared_seg else 0),
                        "phase_s": dict(eng.phase_s),
                        "prefills": eng.prefills,
                        "prefill_positions": eng.prefill_positions,
                        "prefill_padded": eng.prefill_padded,
                        "trace_dropped": trace.dropped(),
                    })
                return self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/v1/cancel":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        payload = json.loads(self.rfile.read(n) or b"{}")
                        rid = int(payload["id"])
                    except Exception as e:
                        return self._json(400, {"error": f"bad JSON: {e}"})
                    t = server._by_id.get(rid)
                    if t is None:
                        return self._json(404,
                                          {"error": f"unknown id {rid}"})
                    server._cancelq.put(t)
                    if not t.done.wait(server.request_timeout):
                        return self._json(504, {"error": "cancel timeout"})
                    return self._json(200, {"cancelled": rid,
                                            **server._result(t)})
                if self.path != "/v1/completions":
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:
                    return self._json(400, {"error": f"bad JSON: {e}"})

                ticket = _Ticket(payload=payload)
                server._subq.put(ticket)
                if not ticket.admitted.wait(server.request_timeout):
                    return self._json(503, {"error": "admission timeout"})
                if ticket.error is not None:
                    return self._json(400, {"error": ticket.error})

                if payload.get("stream"):
                    return self._stream(ticket)
                if not ticket.done.wait(server.request_timeout):
                    return self._json(504, {"error": "generation timeout"})
                if ticket.error is not None:
                    return self._json(500, {"error": ticket.error})
                return self._json(200, server._result(ticket))

            def _stream(self, ticket: _Ticket):
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj: dict):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                while True:
                    try:
                        part = ticket.chunks.get(
                            timeout=server.request_timeout)
                    except queue.Empty:
                        chunk({"error": "generation timeout"})
                        break
                    try:
                        if part is None:
                            chunk({"done": True, **server._result(ticket)})
                            break
                        chunk(part)
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        # client went away: free its slot for other work
                        server._cancelq.put(ticket)
                        return
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass

        return Handler

    def _result(self, ticket: _Ticket) -> dict:
        req = ticket.request
        out = {"id": req.id, "tokens": list(req.tokens),
               "num_tokens": len(req.tokens)}
        if ticket.payload.get("logprobs"):
            out["logprobs"] = list(req.logprobs)
        if self.tokenizer is not None:
            try:
                out["text"] = self.tokenizer.decode(req.tokens)
            except Exception:
                pass
        return out
