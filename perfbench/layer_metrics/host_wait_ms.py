"""``host_wait_ms``: main-thread ms a profiled engine step spends inside
the program's ``serve.wait`` spans, where the engine blocks on the card
(an event's ``synchronize``, a read of a device value) or on its reader
thread."""

from perfbench.layer_metrics import _spans


def read(r):
    found = _spans.spans(r)
    if found is None:
        return None
    lo, hi = _spans.window(r.profile)
    ns = sum(min(s.end, hi * 1e3) - max(s.start, lo * 1e3)
             for s in _spans.main_thread(found) if s.name == "serve.wait")
    return ns / 1e6 / r.profile_steps
