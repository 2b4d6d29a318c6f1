"""``moe_route_ms``: device ms a forward spends routing the MoE layers'
tokens (the program's ``moe.route`` spans: the fp32 router, top-k, the
sort by expert, the gather of the rows) and combining the experts' outputs
(``moe.combine``), between each span's CUDA events. None where the
program records no such span."""

from perfbench.layer_metrics import _lfm2


def read(r):
    return _lfm2.span_ms(r, ("moe.route", "moe.combine"))
