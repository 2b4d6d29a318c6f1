"""``mfu``: the whole step's share of the chip's bf16 peak: the model FLOPs
of the work the unprofiled window completed (``perfbench/roofline.py``:
the published model on these inputs, no recomputation) over its length."""

from perfbench import roofline


def read(r):
    if r is None or r.window_s <= 0 or r.model_flops <= 0:
        return None
    return 100.0 * r.model_flops / r.window_s / roofline.H100_BF16_FLOPS
