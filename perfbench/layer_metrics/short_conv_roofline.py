"""``short_conv_roofline``: the short conv kernel (the program's
``op.short_conv`` spans) against the bound of its arguments' bytes
(``perfbench/roofline_lfm2.py``), over the device time between each span's
CUDA events. None where the program records no such span."""

from perfbench import roofline_lfm2
from perfbench.layer_metrics import _lfm2


def _work(a):
    return roofline_lfm2.short_conv_work(a["rows"], a["width"], a["taps"],
                                         a["itemsize"])


def read(r):
    return _lfm2.share(r, ("op.short_conv",), {"op.short_conv": _work})
