"""The window's verified signatures' least time on the card (the frozen bound
model in perfbench/bound.py, on live lanes) over all kernel time on the
card in the traced window, in percent."""
from perfbench import bound


def read(w):
    if w.trace is None or w.trace["kernel_s"] <= 0 or not w.counters["lanes_sum"]:
        return None
    least, _ = bound.least_seconds(int(w.counters["lanes_sum"]))
    return 100.0 * least / w.trace["kernel_s"]
