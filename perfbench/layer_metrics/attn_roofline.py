"""``attn_roofline``: the LFM2 attention's kernels, the QK-norm/RoPE pass
(``op.qk_norm_rope`` spans) and the flash forward over grouped key/value
heads (``op.flash_fwd`` spans, K and V counted at their ``kv_heads``),
against the bound of their arguments' work over their device time
together. None where the program records neither."""

from perfbench import roofline_lfm2
from perfbench.layer_metrics import _lfm2


def _qk(a):
    return roofline_lfm2.qk_norm_rope_work(a["rows"], a["heads"],
                                           a["kv_heads"], a["length"],
                                           a["itemsize"])


def _flash(a):
    return roofline_lfm2.flash_fwd_gqa_work(
        a["b"], a["h"], a.get("kv_heads", a["h"]), a["lq"], a["lk"],
        a["d"], causal=a["causal"], itemsize=a["itemsize"])


def read(r):
    return _lfm2.share(r, ("op.qk_norm_rope", "op.flash_fwd"),
                       {"op.qk_norm_rope": _qk, "op.flash_fwd": _flash})
