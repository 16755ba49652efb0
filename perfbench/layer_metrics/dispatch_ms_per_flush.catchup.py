"""Host milliseconds a flush spends in dispatch: the benchmark's own spans
around the backend's ``verify_signatures_async`` (pack-to-wire, upload and
launches, which return before the kernels finish), taken inside the executor
thread that submits it, over the dispatches that started in the window.  The
executor's queue wait and the wait for the result are not in it; waits for
the GIL inside the call are."""


def read(w):
    if w.trace is None or not w.trace["dispatches"]:
        return None
    return w.trace["dispatch_s"] / w.trace["dispatches"] * 1e3
