"""Share of its roofline one ``megastep_block`` launch (a whole trace
window of the batch) reaches: its bound (``roofline/megastep_block.py``)
over the mean CUDA-event span of the traced sweep's replayed windows, per
cent."""

from ccbench.roofline import megastep_block as roof


def read(rec):
    if rec["tier"] != "mega" or not rec["window_ms"]:
        return None
    span_s = sum(rec["window_ms"]) * 1e-3 / len(rec["window_ms"])
    return 100.0 * roof.bound_s(rec["shapes"], rec["trace_every"]) / span_s
