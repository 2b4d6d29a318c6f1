"""``decode_attn_roofline``: ``decode_attention`` over the KV pool against
the bound of its arguments' work: each row's first ``kv_len`` cache
positions."""

from perfbench import roofline, trace


def _work(call):
    h, d, q_itemsize, kv_itemsize, scales = call.shapes
    return roofline.decode_work(call.extra.tolist(), h, d,
                                q_itemsize=q_itemsize,
                                kv_itemsize=kv_itemsize, scales=scales)


def read(r):
    return roofline.entry_share(r, (trace.DECODE,), _work)
