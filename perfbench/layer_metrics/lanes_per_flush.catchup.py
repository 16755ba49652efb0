"""Live lanes a collector flush dispatched in the window: the delta of the
program's verify_dispatch_batch_size sum over its count."""


def read(w):
    if not w.counters["lanes_count"]:
        return None
    return w.counters["lanes_sum"] / w.counters["lanes_count"]
