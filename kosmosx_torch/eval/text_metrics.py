"""Text-generation metrics: corpus BLEU-4, ROUGE-L, token F1 and exact
match (the port's own copy of kosmosx_tpu/eval/text_metrics.py, plain
Python, no external dependencies).

- ``bleu``: corpus BLEU-N with uniform weights, the Papineni-2002 brevity
  penalty and clipped n-gram precision (+1 smoothing on empty counts).
- ``rouge_l``: LCS-based F-measure (Lin 2004).
- ``token_f1``: SQuAD-style bag-of-tokens F1.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence, Union

Tokens = Union[str, Sequence[str]]


def _toks(x: Tokens) -> List[str]:
    return x.split() if isinstance(x, str) else list(x)


def _ngrams(toks: List[str], n: int) -> Counter:
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


def bleu(candidates: Sequence[Tokens], references: Sequence[Tokens],
         max_n: int = 4) -> float:
    """Corpus BLEU-N (default BLEU-4), single reference per candidate."""
    assert len(candidates) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = ref_len = 0
    for cand, ref in zip(candidates, references):
        c, r = _toks(cand), _toks(ref)
        cand_len += len(c)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            cg, rg = _ngrams(c, n), _ngrams(r, n)
            totals[n - 1] += max(len(c) - n + 1, 0)
            clipped[n - 1] += sum(min(cnt, rg[g]) for g, cnt in cg.items())
    if cand_len == 0:
        return 0.0
    log_p = 0.0
    for n in range(max_n):
        # +1 smoothing only when a higher-order count is zero (method-1 style)
        num = clipped[n] if clipped[n] > 0 else (1 if n > 0 else 0)
        den = totals[n] if totals[n] > 0 else 1
        if num == 0:
            return 0.0
        log_p += math.log(num / den) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / cand_len)
    return bp * math.exp(log_p)


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(candidate: Tokens, reference: Tokens, beta: float = 1.2) -> float:
    """ROUGE-L F-measure (Lin 2004, eq. 4-6)."""
    c, r = _toks(candidate), _toks(reference)
    lcs = _lcs_len(c, r)
    if lcs == 0:
        return 0.0
    prec = lcs / len(c)
    rec = lcs / len(r)
    return (1 + beta ** 2) * prec * rec / (rec + beta ** 2 * prec)


def token_f1(candidate: Tokens, reference: Tokens) -> float:
    """SQuAD-style bag-of-tokens F1."""
    c, r = Counter(_toks(candidate)), Counter(_toks(reference))
    overlap = sum((c & r).values())
    if overlap == 0:
        return 0.0
    prec = overlap / sum(c.values())
    rec = overlap / sum(r.values())
    return 2 * prec * rec / (prec + rec)


def exact_match(candidate: Tokens, reference: Tokens) -> float:
    return float(_toks(candidate) == _toks(reference))
