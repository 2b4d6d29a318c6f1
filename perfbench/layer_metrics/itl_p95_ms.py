"""``itl_p95_ms``: the 95th percentile of every gap between two tokens of
one request committed in the unprofiled window."""


def read(r):
    if r is None:
        return None
    return r.engine.get("itl_p95_ms")
