"""``prefill_pad_share``: of all positions the profiled sub-window's
whole-prompt prefills computed (the program's ``serve.prefill`` spans),
the share that was padding, in %."""

from perfbench.layer_metrics import _spans


def read(r):
    found = _spans.spans(r)
    if found is None:
        return None
    prefills = [s.attrs for s in found if s.name == "serve.prefill"]
    total = sum(a["real"] + a["padded"] for a in prefills)
    if not total:
        return None
    return 100.0 * sum(a["padded"] for a in prefills) / total
