"""``idle_optimizer_ms``: device-idle ms a profiled training step while
the host's main thread is inside the program's ``train.optimizer`` span
(the clip's norm and the update's launches)."""

from perfbench.layer_metrics import _spans


def read(r):
    return _spans.idle_ms(r, under=("train.optimizer",))
