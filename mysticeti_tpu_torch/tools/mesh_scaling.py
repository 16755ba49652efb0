"""Multi-card sharding scaling curve.

The port's copy of the JAX package's ``tools/mesh_scaling.py``.  For each
mesh size, the SAME fixed global batch is sharded over an n-device mesh
through the deployed committee-indexed path
(``parallel/mesh.py:sharded_verify_batch_indexed``), asserting that every
lane verifies and that the summed valid count (the JAX tool's psum) equals
the batch, and timing the step on the host's clock (the call fetches its
verdicts).  Each mesh size runs in a child process of its own, as in the
JAX tool.

The mesh is the attached cards (``--real``, the JAX tool's flag for real
devices, is the default here): a size larger than the number of cards fails
with a message before any point runs.  ``--device cpu`` runs each size over
``["cpu"] * n``, n shards of the kernels' plain versions in one process
(the counterpart of the JAX tool's virtual CPU devices): those points check
the sharding, per-shard shapes and totals, not a speedup.

Usage:
  python -m mysticeti_tpu_torch.tools.mesh_scaling [--sizes 1 2 4 8]
      [--device cpu] [--out build/MULTICHIP_SCALING.json]
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

from mysticeti_tpu_torch.tools import REPO, build_path, card, launch_counts, write_json

DEFAULT_OUT = build_path("MULTICHIP_SCALING.json")


def point(n: int, batch: int, device: str) -> dict:
    """One mesh size: ``n`` shards over the first ``n`` cards (``device``
    "cuda") or over ``["cpu"] * n``; the JAX tool's assertions, then the
    step's seconds over 3 iterations."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.crypto import Ed25519PrivateKey
    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.parallel.mesh import make_mesh, sharded_verify_batch_indexed

    if device == "cpu":
        mesh = make_mesh(n, devices=["cpu"] * n)
    else:
        E.resolve_device(device)
        cards = torch.cuda.device_count()
        if cards < n:
            raise SystemExit(f"need {n} devices, have {cards}")
        mesh = make_mesh(n)

    rng = random.Random(5)
    keys = [
        Ed25519PrivateKey.from_private_bytes(bytes(rng.randrange(256) for _ in range(32)))
        for _ in range(16)
    ]
    table = E.KeyTable([k.public_key().public_bytes_raw() for k in keys], device=mesh.devices[0])
    pks, msgs, sigs = [], [], []
    for i in range(batch):
        k = keys[i % 16]
        m = bytes(rng.randrange(256) for _ in range(32))
        pks.append(k.public_key().public_bytes_raw())
        msgs.append(m)
        sigs.append(k.sign(m))

    # Warm, and the correctness assertions of the dry run.
    ok, total = sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    ok = np.asarray(ok)
    if ok.shape != (batch,):
        raise RuntimeError(f"verdicts of shape {ok.shape}, want ({batch},)")
    if not ok.all():
        raise RuntimeError("all signatures must verify")
    if int(total) != batch:
        raise RuntimeError(f"summed valid count {total} != {batch}")

    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        ok, total = sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
        if int(total) != batch:
            raise RuntimeError(f"summed valid count {total} != {batch}")
    elapsed = (time.perf_counter() - t0) / iters
    return {
        "devices": n,
        "mesh": [str(d) for d in mesh.devices],
        "global_batch": batch,
        "per_shard_batch": batch // n,
        "psum_total_ok": True,
        "step_s": elapsed,
        "sig_per_s": batch / elapsed,
        "launches": launch_counts(),
    }


CHILD = ("import json, sys; from mysticeti_tpu_torch.tools.mesh_scaling import point; "
         "print(json.dumps(point(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])))")


def run_point(n: int, batch: int, device: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(n), str(batch), device],
        cwd=REPO, capture_output=True, text=True, timeout=1200,
    )
    if out.returncode != 0:
        raise RuntimeError(f"mesh point n={n} failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--real", action="store_true",
                        help="the attached cards (the default; the JAX "
                        "tool's flag for real devices)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu: each size over ['cpu'] * n, the kernels' "
                        "plain versions")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    if args.device == "cuda":
        import torch

        from mysticeti_tpu_torch.ops import ed25519 as E

        E.resolve_device("cuda")
        cards = torch.cuda.device_count()
        too_big = [n for n in args.sizes if n > cards]
        if too_big:
            parser.error(f"--sizes {too_big} exceed the {cards} attached card(s)")

    points = []
    for n in args.sizes:
        print(f"mesh point: {n} device(s), global batch {args.batch}...", flush=True)
        p = run_point(n, args.batch, args.device)
        points.append(p)
        print(json.dumps(p), flush=True)

    on_card = args.device == "cuda"
    artifact = {
        "metric": "sharded_verify_scaling_curve",
        "config": {
            "path": "parallel/mesh.py:sharded_verify_batch_indexed "
                    "(committee-indexed blob, batch-axis sharding, summed "
                    "valid-count reduction)",
            "global_batch_fixed": args.batch,
            "platform": "the attached cards" if on_card else
                        "n shards of the plain versions on the CPU",
            "card": card() if on_card else None,
            "note": (
                "Each point holds per-shard shapes and the summed valid "
                "count at fixed global work; CPU points share the host's "
                "cores, so their step_s measures partitioning overhead, "
                "not speedup."
            ),
        },
        "points": points,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
