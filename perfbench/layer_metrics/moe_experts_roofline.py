"""``moe_experts_roofline``: the MoE's expert SwiGLU (the program's
``op.moe_experts`` spans: the grouped products and the activation between
them) against the bound of its arguments' work, the operations at 989
TFLOP/s (``perfbench/roofline_lfm2.py``). None where the program records
no such span."""

from perfbench import roofline_lfm2
from perfbench.layer_metrics import _lfm2


def _work(a):
    return roofline_lfm2.moe_experts_work(a["assignments"], a["experts"],
                                          a["d"], a["ffn"], a["itemsize"])


def read(r):
    return _lfm2.share(r, ("op.moe_experts",), {"op.moe_experts": _work})
