"""``flash_bwd_roofline``: ``flash_attention_bwd`` (its pre-pass, dK/dV and
dQ kernels together) against the bound of its arguments' work."""

from perfbench import roofline, trace


def _work(call):
    b, h, lq, d, lk, causal, itemsize = call.shapes
    return roofline.flash_bwd_work(b, h, lq, lk, d, causal=causal,
                                   itemsize=itemsize)


def read(r):
    return roofline.entry_share(r, (trace.FLASH_BWD,), _work)
