"""``idle_loop_ms``: device-idle ms a profiled training step while the
host's main thread is inside none of the program's ``train.forward``,
``train.backward`` and ``train.optimizer`` spans: the loop around the
step (the next batch, the log and its reads, checkpoints) and the
benchmark's own code."""

from perfbench.layer_metrics import _spans


def read(r):
    return _spans.idle_ms(r, outside_of=_spans.LOOP_WORK)
