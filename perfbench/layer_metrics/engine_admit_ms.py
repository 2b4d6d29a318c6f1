"""``engine_admit_ms``: the host's wall time an admitted request spends in
the engine's admit phase (`phase_s["admit"]` over the requests
admitted), over the unprofiled window."""


def read(r):
    if r is None:
        return None
    return r.engine.get("admit_ms")
