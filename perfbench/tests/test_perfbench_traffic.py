"""Each generator is deterministic for a seed, and every seed serves the
same sizes in another order."""

import json
from collections import Counter

import torch

from perfbench import traffic, weights
from perfbench.harness import load_module
from perfbench.tests.perfbench_tiny import CONFIG, ROOT, TRAFFIC

BIG = 2 ** 31 + 12345
train = load_module(ROOT, "drivers", "train")
score = load_module(ROOT, "drivers", "score")


def _serve_mix():
    return json.loads((ROOT / "perfbench/traffic/serve-long-c128.json")
                      .read_text())


def test_serve_sizes_follow_the_mix():
    mix = _serve_mix()
    shapes = traffic.shapes(mix)
    assert shapes == traffic.shapes(mix)
    lengths = [s.prompt_len for s in shapes]
    assert min(lengths) >= 512 and max(lengths) <= 1792
    assert 950 <= sorted(lengths)[len(lengths) // 2] <= 1100
    assert sum(s.image for s in shapes) == round(0.25 * len(shapes))
    assert {s.new_tokens for s in shapes} == set(range(32, 129))


def _draw(seed, n=40):
    s = traffic.Stream(TRAFFIC["serve"], CONFIG, seed, "cpu")
    out = [s.next() for _ in range(n)]
    return [(r.prompt, None if r.images is None else r.images.sum().item(),
             r.new_tokens) for r in out], s


def test_serve_stream_is_deterministic():
    a, sa = _draw(BIG)
    b, _ = _draw(BIG)
    c, sc = _draw(BIG + 1)
    assert a == b and a != c
    # the same multiset of sizes, in another order
    assert Counter(map(str, (sa.shapes[i] for i in sa.order))) == \
        Counter(map(str, (sc.shapes[i] for i in sc.order)))
    assert list(sa.order) != list(sc.order)


def test_train_and_score_feeds_are_deterministic():
    def draws(kind, seed):
        if kind == "train":
            f = train.Feed(CONFIG, TRAFFIC["train"], seed, "cpu")
            return [f.next() for _ in range(3)]
        f = score.Inputs(CONFIG, TRAFFIC["score"], seed, "cpu")
        return [dict(zip(("text_tokens", "images"), f.next()))
                for _ in range(3)]

    for kind in ("train", "score"):
        a, b, c = draws(kind, BIG), draws(kind, BIG), draws(kind, 7)
        for x, y in zip(a, b):
            assert all(torch.equal(x[k], y[k]) for k in x)
        assert not torch.equal(a[0]["text_tokens"], c[0]["text_tokens"])
        # every row of every batch differs
        rows = torch.cat([x["text_tokens"] for x in a])
        assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_weights_are_deterministic_and_chunked():
    a = weights.make_weights(CONFIG, BIG, "cpu")
    b = weights.make_weights(CONFIG, BIG, "cpu")
    c = weights.make_weights(CONFIG, BIG + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.out_proj.w"], c["decoder.out_proj.w"])
    assert float(a["decoder.embed.table"][1].abs().sum()) == 0.0
    # a chunk drawn again alone is the same
    for name, part in weights.iter_chunks(CONFIG, BIG, "cpu", torch.float32):
        assert all(torch.equal(part[k], a[k]) for k in part), name
