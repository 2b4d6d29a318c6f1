"""kosmosx_torch's data loaders, packing binding and metrics logger against
kosmosx_tpu's on the CPU.

Every loader is fed the same files as JAX's and must yield the same
arrays byte for byte (dtype, shape, values): packed text with its EOS after
every document and its carry across library calls and batches,
pretokenized ``.npy`` (1-D and rows) and ``.bin`` (sidecar dtype and the
uint16 default) streams across file boundaries, image+caption batches
from ``.npy`` (channel-first and -last) and ``.png`` images (PIL resizing
one of them) with the reserve of ``1 + 2 * modalities`` tokens and the pad
ids, text-file and ``datasets`` streams (a stub ``datasets`` module), the
round-robin shard. The port's native packing library equals its numpy
version. ``MetricsLogger`` writes JAX's records (every key but the wall
clock's ``time``).
"""

import itertools
import json
import sys
import types

import numpy as np
import pytest
import torch

from kosmosx_torch.data import native as tnative
from kosmosx_torch.data.tokenizer import KosmosTokenizer as TTokenizer
from kosmosx_torch.train import data as tdata
from kosmosx_torch.train import metrics as tmetrics
from kosmosx_tpu.data.tokenizer import KosmosTokenizer as JTokenizer
from kosmosx_tpu.train import data as jdata
from kosmosx_tpu.train import metrics as jmetrics

WORDS = "the a cat dog sat on mat ran far and jumped over fence".split()


def _same(a_iter, b_iter):
    n = 0
    for a, b in itertools.zip_longest(a_iter, b_iter):
        assert a is not None and b is not None, f"lengths differ at {n}"
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            pairs = [(a[k], b[k]) for k in a]
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes(), n
        n += 1
    return n


def _docs(seed, n, lo=1, hi=400):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 30000, rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def test_native_library_equals_numpy():
    assert tnative.native_available()
    docs = _docs(0, 50)
    for seq_len, carry in ((16, None), (64, np.arange(5, dtype=np.int32)),
                           (7, np.arange(6, dtype=np.int32))):
        a = tnative.pack_blocks(docs, seq_len, 2, carry)
        b = tnative.pack_blocks_np(docs, seq_len, 2, carry)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    # Empty documents, no documents, and a carry of seq_len or more (which
    # the C entry hands back to numpy).
    for docs, seq_len, carry in (
            (_docs(1, 9, 0, 20), 12, np.arange(11, dtype=np.int32)),
            ([], 4, np.arange(9, dtype=np.int32)),
            ([np.zeros((0,), np.int32)] * 5, 2, None)):
        a = tnative.pack_blocks(docs, seq_len, 2, carry)
        b = tnative.pack_blocks_np(docs, seq_len, 2, carry)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seq_len,batch", [(64, 3), (1000, 2)])
def test_packed_text_batches_match_jax(seq_len, batch):
    """About 150k tokens: more than one library call of 65536 tokens, so
    the carry crosses calls as well as batches."""
    docs = _docs(3, 800)
    assert _same(
        jdata.packed_text_batches(iter(docs), batch_size=batch,
                                  seq_len=seq_len, eos_id=2),
        tdata.packed_text_batches(iter(docs), batch_size=batch,
                                  seq_len=seq_len, eos_id=2)) > 10
    blocks = list(tdata.group_texts(iter(docs[:3]), 8, eos_id=2))
    flat = np.concatenate([np.append(d, 2) for d in docs[:3]])
    assert np.array_equal(np.concatenate(blocks), flat[:len(blocks) * 8])


def test_pretokenized_batches_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    files = []
    a = rng.integers(0, 60000, 1001).astype(np.uint16)
    np.save(tmp_path / "a.npy", a)
    files.append(str(tmp_path / "a.npy"))
    rows = rng.integers(0, 50000, (7, 33)).astype(np.int32)
    np.save(tmp_path / "rows.npy", rows)
    files.append(str(tmp_path / "rows.npy"))
    rng.integers(0, 1 << 20, 517).astype(np.uint32).tofile(tmp_path / "c.bin")
    (tmp_path / "c.json").write_text(json.dumps({"dtype": "uint32"}))
    files.append(str(tmp_path / "c.bin"))
    rng.integers(0, 60000, 300).astype(np.uint16).tofile(tmp_path / "d.bin")
    files.append(str(tmp_path / "d.bin"))
    for seq_len, batch in ((33, 2), (50, 3)):
        assert _same(jdata.pretokenized_batches(files, batch_size=batch,
                                                seq_len=seq_len),
                     tdata.pretokenized_batches(files, batch_size=batch,
                                                seq_len=seq_len)) > 5
    assert _same(jdata.pretokenized_stream(files, seq_len=40, slab_tokens=97),
                 tdata.pretokenized_stream(files, seq_len=40, slab_tokens=97))


def _caption_dir(tmp_path, size=28):
    from PIL import Image

    rng = np.random.default_rng(5)
    recs = []
    for i in range(5):
        text = " ".join(rng.choice(WORDS, rng.integers(3, 30)))
        if i == 0:  # channel-last npy
            np.save(tmp_path / f"{i}.npy",
                    rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
            recs.append({"image": f"{i}.npy", "text": text})
        elif i == 1:  # a png PIL resizes and crops
            Image.fromarray(rng.integers(0, 256, (size + 9, size + 17, 3)).astype(
                np.uint8)).save(tmp_path / f"{i}.png")
            recs.append({"file": f"{i}.png", "caption": text})
        elif i == 2:
            Image.fromarray(rng.integers(0, 256, (size, size, 3)).astype(
                np.uint8)).save(tmp_path / f"{i}.png")
            recs.append({"image_path": str(tmp_path / f"{i}.png"),
                         "target_text": text})
        else:
            np.save(tmp_path / f"{i}.npy",
                    rng.integers(0, 256, (3, size, size)).astype(np.uint8))
            recs.append({"image": f"{i}.npy", "text": text})
    (tmp_path / "captions.jsonl").write_text(
        "\n".join(json.dumps(r) for r in recs) + "\n\n")
    return tmp_path


@pytest.mark.parametrize("text_len", [12, 64])
def test_image_caption_batches_match_jax(tmp_path, text_len):
    """Captions encoded to at most ``text_len - 3`` tokens (BOS included),
    so a cut row still ends in one pad after its two tags, or padded; two
    epochs, the last partial batch of each dropped."""
    root = str(_caption_dir(tmp_path))
    jtok = JTokenizer(use_hf=False, image_size=28)
    ttok = TTokenizer(use_hf=False, image_size=28)
    assert ttok.hf is None and jtok.hf is None
    n = _same(jdata.image_caption_batches(root, jtok, batch_size=2,
                                          text_len=text_len, epochs=2),
              tdata.image_caption_batches(root, ttok, batch_size=2,
                                          text_len=text_len, epochs=2))
    assert n == 4
    assert _same(jdata.image_caption_samples(root, image_size=28),
                 tdata.image_caption_samples(root, image_size=28)) == 5
    first = next(tdata.image_caption_batches(root, ttok, batch_size=2,
                                             text_len=text_len))
    row = first["text_tokens"][0]
    assert row[0] == ttok.bos_token_id and row[1] == ttok.im_idx
    real = int((row != ttok.pad_token_id).sum())
    assert real == 11 if text_len == 12 else real < 64


def test_text_file_and_hf_streams_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    lines = [" ".join(rng.choice(WORDS, rng.integers(1, 20))) for _ in range(30)]
    lines[4] = "   "
    path = tmp_path / "docs.txt"
    path.write_text("\n".join(lines) + "\n")
    jtok, ttok = JTokenizer(use_hf=False), TTokenizer(use_hf=False)
    assert _same(jdata.text_file_stream([str(path)], jtok),
                 tdata.text_file_stream([str(path)], ttok)) == 29

    calls = []

    def load_dataset(name, *args, split, streaming):
        calls.append((name, args, split, streaming))
        return [{"text": t} for t in lines] + [{"text": ""}]

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load_dataset))
    kw = dict(split="validation", config="en")
    # the blank line is a document here (only an empty text is skipped)
    assert _same(jdata.hf_dataset_stream("owt", jtok, **kw),
                 tdata.hf_dataset_stream("owt", ttok, **kw)) == 30
    assert calls[0] == calls[1] == ("owt", ("en",), "validation", True)
    stream = tdata.hf_dataset_stream("owt", ttok)  # imports at first item
    assert len(calls) == 2 and next(stream) and len(calls) == 3


def test_shard_stream_matches_jax():
    for index in range(3):
        assert _same(jdata.shard_stream(iter(range(20)), index, 3),
                     tdata.shard_stream(iter(range(20)), index, 3)) > 5
    with pytest.raises(ValueError):
        list(tdata.shard_stream(iter(range(3)), 3, 3))


def test_metrics_logger_records_match_jax(tmp_path):
    records = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        path = tmp_path / f"{name}.jsonl"
        logger = mod.MetricsLogger(jsonl_path=str(path), use_wandb=True)
        for step in (1, 2):
            logger(step, {"loss": torch.tensor(2.5 / step) if name == "torch"
                          else np.float32(2.5 / step), "lr": 1e-4,
                          "tokens": 7, "note": "x"})
        logger.close()
        records[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
    for a, b in zip(records["jax"], records["torch"]):
        a.pop("time"), b.pop("time")
        assert a == b
    assert len(records["torch"]) == 2
