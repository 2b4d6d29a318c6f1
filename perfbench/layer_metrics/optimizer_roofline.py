"""``optimizer_roofline``: the optimizer's least time over its device time,
in percent. The least time moves every trainable leaf's parameter and
moments in and out once and reads each gradient the step got once, at the
HBM rate, whatever implements the update; the bytes come from the leaves'
shapes and dtypes, which the program's ``train.update`` spans record
(``param_bytes``, ``moment_bytes``, ``grad_bytes``). The device time is
``optimizer_ms``'s: the kernels launched inside ``Optimizer.step``. None
where the program's spans carry no bytes (a program older than them)."""

from perfbench import roofline, trace
from perfbench.layer_metrics import _spans

KEYS = ("param_bytes", "moment_bytes", "grad_bytes")


def read(r):
    found = _spans.spans(r)
    if found is None:
        return None
    updates = [s.attrs for s in found
               if s.name == "train.update" and all(k in s.attrs for k in KEYS)]
    device_s = r.profile.span_device_s.get(trace.OPTIMIZER)
    if not updates or not device_s:
        return None
    nbytes = sum(2 * (a["param_bytes"] + a["moment_bytes"]) + a["grad_bytes"]
                 for a in updates)
    return 100.0 * roofline.bound_s((0, nbytes)) / device_s
