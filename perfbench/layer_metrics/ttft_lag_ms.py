"""``ttft_lag_ms``: the median ms, over the requests prefilled in the
profiled sub-window, from the end of a request's ``serve.prefill`` span to
the end of the ``serve.commit`` span that commits its first token (a
drained entry's span lists its ``requests`` and their ``tokens``): how
long a sampled first token waits on the host before a client sees it.

A first token commits some engine steps after its prefill, so a request
prefilled in the sub-window's last steps may commit after it ends. Every
request prefilled within that many steps of the end (the most any request
of the sub-window took, counted in ``serve.step`` spans) is left out, not
only those whose commit is missing: keeping the ones that happened to
commit in time would keep the short waits of those steps and drop the
long."""

import bisect
import statistics

from perfbench.layer_metrics import _spans


def read(r):
    found = _spans.spans(r)
    if found is None:
        return None
    steps = sorted(s.start for s in _spans.main_thread(found)
                   if s.name == "serve.step")

    def step_of(t):
        return bisect.bisect_right(steps, t) - 1

    prefilled = {}
    for s in found:
        if s.name == "serve.prefill":
            ids = s.attrs.get("requests") or [s.attrs.get("request")]
            for i in ids:
                if i is not None:
                    prefilled.setdefault(i, s.end)
    first = {}
    for s in sorted(found, key=lambda x: x.start):
        if s.name != "serve.commit":
            continue
        ids, tokens = s.attrs.get("requests"), s.attrs.get("tokens")
        if ids is None:   # one request's commit
            ids, tokens = [s.attrs.get("request")], [tokens]
        for i, n in zip(ids, tokens):
            if n and i in prefilled and i not in first \
                    and s.start >= prefilled[i]:
                first[i] = s.end
    if not first:
        return None
    horizon = max(step_of(first[i]) - step_of(prefilled[i]) for i in first)
    last = len(steps) - 1 - horizon
    lags = [first[i] - prefilled[i] for i in first
            if step_of(prefilled[i]) <= last]
    if not lags:
        return None
    return statistics.median(lags) / 1e6
