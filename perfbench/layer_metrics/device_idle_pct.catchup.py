"""Share of the traced window in which no kernel, copy or memset ran on the
card, from torch.profiler's trace, in percent."""


def read(w):
    if w.trace is None:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.seconds)
