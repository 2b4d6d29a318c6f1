"""``head_ms``: device ms a profiled forward spends in the output head
(``dec.output_logits``), between the CUDA events the program's
``model.head`` span records on the stream."""

from perfbench.layer_metrics import _spans


def read(r):
    found = _spans.spans(r)
    if found is None:
        return None
    times = [s.device_ms for s in found if s.name == "model.head"]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / r.profile_steps
