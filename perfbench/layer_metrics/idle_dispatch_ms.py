"""``idle_dispatch_ms``: device-idle ms a profiled engine step while the
host's main thread is inside the program's ``serve.dispatch`` span (the
decode step's launches over the pool)."""

from perfbench.layer_metrics import _spans


def read(r):
    return _spans.idle_ms(r, under=("serve.dispatch",))
