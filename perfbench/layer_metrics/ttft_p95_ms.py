"""``ttft_p95_ms``: the 95th percentile of the time to first token of
every request sent in the unprofiled window, from its sending to its
first committed token (the engine keeps stepping after the window until
each has one; one that never comes counts as infinite)."""


def read(r):
    if r is None:
        return None
    return r.engine.get("ttft_p95_ms")
