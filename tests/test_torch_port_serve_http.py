"""kosmosx_torch's HTTP server and serving CLI on the CPU: the endpoints of
tests/test_serve_http.py over the port's engine (answers equal to the
engine's own tokens), and tiny ``--device cpu`` runs of
``python -m kosmosx_torch.scripts.serve``."""

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from kosmosx_torch.generate.sampler import SamplingConfig
from kosmosx_torch.serve import ServeConfig, ServeEngine, ServeServer
from tests.test_torch_port_serve import TCFG
from kosmosx_torch.models.language import KosmosLanguage

PROMPTS = [[5, 6, 7], [8, 9, 10, 11], [12, 13], [14, 15, 16, 17, 18]]
NEW = 6


@pytest.fixture(scope="module")
def model():
    return KosmosLanguage(TCFG, generator=torch.Generator().manual_seed(0),
                          device="cpu")


def _engine(model, **kw):
    return ServeEngine(model, TCFG,
                       ServeConfig(max_batch=2, max_prompt_len=16, max_len=48,
                                   **kw),
                       SamplingConfig(greedy=True), device="cpu")


@pytest.fixture(scope="module")
def direct(model):
    eng = _engine(model)
    hs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
    eng.run()
    return [h.tokens for h in hs]


class _Tok:
    def encode(self, s):
        return [4 + (ord(c) % 90) for c in s]

    def decode(self, ids):
        return "".join(chr(97 + i % 26) for i in ids)


@pytest.fixture
def server(model):
    srv = ServeServer(_engine(model), port=0, tokenizer=_Tok()).start()
    yield srv
    srv.stop()


def _url(srv, path):
    return f"http://{srv.address[0]}:{srv.address[1]}{path}"


def _post(srv, path, payload, timeout=60):
    req = urllib.request.Request(_url(srv, path),
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return r.status, json.loads(r.read())


def test_endpoints_answer_the_engine_tokens(server, direct):
    """Four concurrent completions, two streaming: each answer's tokens are
    the engine's own; /healthz and /v1/stats answer."""
    assert _get(server, "/healthz") == (200, {"ok": True})
    results = [None] * len(PROMPTS)

    def call(i):
        stream = i % 2 == 1
        status, body = _post(server, "/v1/completions",
                             {"prompt": PROMPTS[i], "max_tokens": NEW,
                              "stream": stream, "logprobs": True})
        assert status == 200
        if stream:
            lines = [json.loads(x) for x in body.decode().splitlines() if x]
            assert lines[-1]["done"]
            toks = [t for x in lines[:-1] for t in x["tokens"]]
            assert toks == lines[-1]["tokens"]
            results[i] = lines[-1]
        else:
            results[i] = json.loads(body)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for res, want in zip(results, direct):
        assert res["tokens"] == want and res["num_tokens"] == NEW
        assert len(res["logprobs"]) == NEW and "text" in res
    status, stats = _get(server, "/v1/stats")
    assert status == 200 and stats["emitted_total"] == len(PROMPTS) * NEW
    assert stats["max_batch"] == 2 and stats["speculative"] is False
    assert set(stats["phase_s"]) == {"admit", "prep", "dispatch", "post",
                                     "drain"}
    assert stats["prefill_positions"] >= stats["prefills"] >= 1
    assert 0 <= stats["prefill_padded"] < stats["prefill_positions"]
    assert stats["trace_dropped"] == 0


def test_bad_requests_answer_4xx(server):
    """A bad payload answers 400, an unknown path 404, a cancel of an
    unknown id 404; a string prompt goes through the tokenizer."""
    for payload in ({"prompt": []}, {"prompt": "x" * 40}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/v1/completions", payload)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/v1/cancel", {"id": 12345})
    assert e.value.code == 404
    status, body = _post(server, "/v1/completions",
                         {"prompt": "hi", "max_tokens": 3})
    assert status == 200 and json.loads(body)["num_tokens"] == 3


def _cli(argv):
    from kosmosx_torch.scripts import serve as cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


TINY = ["--device", "cpu", "--layers", "2", "--dim", "64", "--ffn-dim", "128",
        "--heads", "2", "--max-positions", "256", "--dtype", "float32",
        "--no-flash", "--slots", "2", "--max-new-tokens", "5"]


@pytest.mark.parametrize("extra", [
    [], ["--w8", "--kv8", "--decode-block", "2"],
    ["--system-prefix", "sys:", "--share-prefix"],
    ["--prefill-chunk", "4", "--sync-lag", "0"]],
    ids=["plain", "w8-kv8-block", "share-prefix", "chunked"])
def test_cli_serves_prompts(extra):
    rc, out, err = _cli(TINY + ["--prompt", "a b c", "--prompt", "d e",
                                "--prompt", "f"] + extra)
    assert rc == 0
    lines = out.splitlines()
    assert [ln.split("]")[0] for ln in lines] == ["[req 0", "[req 1",
                                                  "[req 2"]
    assert "15 tokens / 3 requests" in err


def test_cli_adapter(tmp_path):
    """--adapter NAME=PATH loads a saved lora tree, --use-adapter serves
    every prompt through it."""
    from kosmosx_torch.core.config import MagnetoConfig
    from kosmosx_torch.train import lora
    from kosmosx_torch.train.checkpoint import save_params

    cfg = MagnetoConfig(vocab_size=32002, embed_dim=64, layers=2, ffn_dim=128,
                        heads=2, max_positions=256, compute_dtype="float32",
                        scan_layers=True, use_flash_attention=False)
    base = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    tree = lora.strip_lora(lora.add_lora(torch.Generator().manual_seed(1),
                                         base, 2))[1]
    save_params(lora.lora_state_dict(tree), str(tmp_path / "a"))
    rc, out, _ = _cli(TINY + ["--prompt", "a b", "--adapter",
                              f"t1={tmp_path / 'a'}", "--use-adapter", "t1"])
    assert rc == 0 and out.startswith("[req 0]")
