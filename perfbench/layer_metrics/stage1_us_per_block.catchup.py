"""Host microseconds of receive stage 1 (decode on the offload worker,
then verify_structure) a block, from the benchmark's own spans around the
stage-1 calls of the window."""


def read(w):
    if not w.stage1_blocks:
        return None
    return w.stage1_busy_s / w.stage1_blocks * 1e6
