"""``flash_fwd_roofline``: ``flash_attention_fwd`` (the xPos rotation pass
and the forward kernel together) against the bound of its arguments'
work."""

from perfbench import roofline, trace


def _work(call):
    b, h, lq, d, lk, causal, itemsize = call.shapes
    return roofline.flash_fwd_work(b, h, lq, lk, d, causal=causal,
                                   itemsize=itemsize)


def read(r):
    return roofline.entry_share(r, (trace.FLASH_FWD,), _work)
