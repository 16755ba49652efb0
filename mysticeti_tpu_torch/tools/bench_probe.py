"""Decompose the end-to-end bench into its serial components on the card:
null round trip, host-to-device bandwidth, kernel-only time, and the
end-to-end number.

The port's copy of the JAX package's ``tools/bench_probe.py``, with the same
readings as the card gives them:

* ``null_rtt_ms``: a one-element op on the card and its ``.item()``;
* ``h2d_MBps``: 8 MB of pageable host memory uploaded and reduced, the sum
  fetched;
* ``kernel_ms_per_batch`` / ``kernel_only_sig_s``: ``keyed_chunk_on_device``
  (the prologue and the keyed kernel) on a resident BENCH_BATCH-lane
  (default 16,384) indexed blob, 8 launches, one synchronize;
* ``e2e_sig_s_16iters`` / ``e2e_ms_per_batch``: 16 x (the index lookup,
  ``pack_blob_indexed``, ``dispatch_indexed_chunks``) then one
  ``fetch_handles``.

The batch is the port bench's own (``bench._build_batch``).  Times are the
host's clock, as in the JAX tool, each region ending in a fetch or a
synchronize; numbers are not rounded.  ``--device cpu`` runs the kernels'
plain versions (no device metric then: the numbers are the host's).  The
record adds ``card`` (``nvidia-smi``'s name and power limit), ``backend``
and the kernels' ``launches``.

Usage: python -m mysticeti_tpu_torch.tools.bench_probe [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mysticeti_tpu_torch.tools import card, launch_counts


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(device=None) -> dict:
    import numpy as np
    import torch

    from mysticeti_tpu_torch.bench import _build_batch
    from mysticeti_tpu_torch.ops import ed25519 as E

    device = E.resolve_device(device)
    on_card = device.type == "cuda"
    out = {"device": torch.cuda.get_device_name(device) if on_card else device.type,
           "card": card() if on_card else None, "backend": device.type}

    # 1. null round trip: a one-element op, its value fetched.
    x = torch.zeros(1, dtype=torch.int32, device=device)
    (x + 1).item()
    t0 = time.perf_counter()
    for _ in range(5):
        (x + 1).item()
    out["null_rtt_ms"] = (time.perf_counter() - t0) / 5 * 1e3

    # 2. host-to-device bandwidth: 8 MB of pageable memory, forced by a
    # reduction whose value is fetched.
    big = np.random.randint(0, 2**31, size=(2 * 1024 * 1024,), dtype=np.int32)
    torch.as_tensor(big).to(device).sum().item()
    t0 = time.perf_counter()
    for _ in range(3):
        torch.as_tensor(big).to(device).sum().item()
    dt = (time.perf_counter() - t0) / 3
    out["h2d_MBps"] = big.nbytes / dt / 1e6

    # 3. kernel-only: the batch resident on the device, 8 launches of the
    # keyed chain, one synchronize (the bench's batch construction).
    batch = int(os.environ.get("BENCH_BATCH", "16384"))
    table, pks, msgs, sigs = _build_batch(batch, seed=0, device=device)
    idx = table.indices_for(pks)
    blob = E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table))
    chunks = [E.to_device_words(E._pad_to(blob[s:s + count], b), device)
              for s, count, b in E.iter_buckets(batch)]
    warm = [E.keyed_chunk_on_device(chunk, table) for chunk in chunks]
    if not all(bool(ok[:count].all()) for ok, (_, count, _) in zip(warm, E.iter_buckets(batch))):
        raise RuntimeError("the bench batch did not verify on the keyed chain")
    iters = 8
    t0 = time.perf_counter()
    for _ in range(iters):
        for chunk in chunks:
            E.keyed_chunk_on_device(chunk, table)
    _sync(device)
    dt = time.perf_counter() - t0
    out["kernel_ms_per_batch"] = dt / iters * 1e3
    out["kernel_only_sig_s"] = batch * iters / dt
    out["blob_bytes_per_batch"] = int(blob.nbytes)

    # 4. packing + upload + kernels + one fetch, as a bench trial does.
    t0 = time.perf_counter()
    handles = []
    for _ in range(16):
        i2 = table.indices_for(pks)
        b2 = E.pack_blob_indexed(i2, msgs, sigs, num_keys=len(table))
        handles.extend(E.dispatch_indexed_chunks(b2, table))
    res = E.fetch_handles(handles)
    dt = time.perf_counter() - t0
    if not res.all():
        raise RuntimeError("the bench batch did not verify end to end")
    out["e2e_sig_s_16iters"] = batch * 16 / dt
    out["e2e_ms_per_batch"] = dt / 16 * 1e3
    out["batch"] = batch
    out["launches"] = launch_counts()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)
    print(json.dumps(probe(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
