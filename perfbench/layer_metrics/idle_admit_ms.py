"""``idle_admit_ms``: device-idle ms a profiled engine step while the
host's main thread is inside the program's ``serve.admit`` or
``serve.admit_many`` span (``_spans.idle_pieces``: the sub-window's idle
time split among the main thread's innermost open spans)."""

from perfbench.layer_metrics import _spans


def read(r):
    return _spans.idle_ms(r, under=_spans.ADMIT)
