"""``w8_roofline``: every ``w8_matmul`` and ``w8_matmul_stacked`` call (the
weight-only int8 products) against the bound of its arguments' work."""

from perfbench import roofline, trace


def _work(call):
    m, k, n, itemsize = call.shapes
    return roofline.w8_matmul_work(m, k, n, x_itemsize=itemsize)


def read(r):
    return roofline.entry_share(r, (trace.W8, trace.W8_STACKED), _work)
