"""``engine_dispatch_ms``: the host's wall time a decode step spends in
`ServeEngine`'s dispatch phase (`phase_s["dispatch"]` over the steps),
over the unprofiled window."""


def read(r):
    if r is None:
        return None
    return r.engine.get("dispatch_ms")
