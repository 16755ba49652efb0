"""One-command same-window fleet A/B: the card's kind against the ``cpu`` kind.

The port's copy of the JAX repository's ``tools/chip_window_ab.py``.  Runs
the verification-bound fleet regime (the ``CATCHUP_r05.json``
configuration: small blocks to raise the block and signature rate, a deep
retain window, a fast leader timeout) as back-to-back ``cpu`` and card
max-load searches (``maxload_bench.search_one``) in one weather window, and
records:

  * the card (nvidia-smi's name and power limit) and the backend the
    kernels were built and warmed on in this process before any fleet
    (``cuda``; without a card the tool raises before any fleet boots);
  * per-probe host weather, inherited from ``maxload_bench``, so the A/B is
    self-contained;
  * the headline ratio of the card kind's peak to the ``cpu`` kind's,
    under the JAX tool's keys (``tpu_peak_committed_tx_s``, ``tpu_over_cpu``),
    which the trend index scores.

``--card-flavor`` is the JAX tool's ``--tpu-flavor``: ``cuda`` (the hybrid
router, the default), ``cuda-only`` or ``cuda-agg``.  The regime's knobs
(``MYSTICETI_MAX_BLOCK_TX``, ``MYSTICETI_RETAIN_ROUNDS``,
``MYSTICETI_LEADER_TIMEOUT``) are set in this process and reach genesis,
the verifier service and every node through the runner's environment.

Usage::

    python -m mysticeti_tpu_torch.tools.chip_window_ab --out build/MAXLOAD_TAX_r19.json
    python -m mysticeti_tpu_torch.tools.chip_window_ab --card-flavor cuda-agg \\
        --duration 30 --iterations 6
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from mysticeti_tpu_torch.tools import build_path, card, write_json
from mysticeti_tpu_torch.tools.maxload_bench import (
    prewarm,
    regime_env,
    search_one,
    set_port_base,
)

DEFAULT_OUT = build_path("CHIPWINDOW.json")
DEFAULT_WORKDIR = build_path("chipwindow")
CARD_FLAVORS = ["cuda", "cuda-only", "cuda-agg"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--start-load", type=int, default=400)
    parser.add_argument("--duration", type=float, default=20.0)
    parser.add_argument("--iterations", type=int, default=5)
    parser.add_argument("--max-block-tx", type=int, default=16)
    parser.add_argument("--card-flavor", default="cuda", choices=CARD_FLAVORS)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)
    os.environ.update(regime_env(args.max_block_tx))

    print("prewarming the kernels...", flush=True)
    backend = prewarm(args.nodes)
    print(f"backend: {backend}", flush=True)

    window_start = time.time()
    runs = []
    for verifier in ("cpu", args.card_flavor):
        print(f"max-load search verifier={verifier}...", flush=True)
        run = asyncio.run(
            search_one(verifier, args.nodes, args.start_load, args.duration,
                       args.iterations, args.workdir)
        )
        runs.append(run)
        print(json.dumps(run), flush=True)

    cpu_peak = runs[0]["peak_committed_tx_s"]
    card_peak = runs[1]["peak_committed_tx_s"]
    artifact = {
        "metric": "same_window_card_vs_cpu_peak_committed_tx_s",
        "card": card(),
        "backend": backend,
        "card_flavor": args.card_flavor,
        "regime": {
            "max_block_tx": args.max_block_tx,
            "retain_rounds": 100000,
            "leader_timeout_s": 0.25,
            "note": (
                "verification-bound fleet shape (CATCHUP_r05 regime): "
                "small blocks maximize signatures per committed tx"
            ),
        },
        "window_utc": [round(window_start, 1), round(time.time(), 1)],
        "cpu_peak_committed_tx_s": cpu_peak,
        "tpu_peak_committed_tx_s": card_peak,
        "tpu_over_cpu": round(card_peak / cpu_peak, 3) if cpu_peak else None,
        "acceptance": (
            "tpu_over_cpu (the card flavor's peak over the cpu kind's, same "
            "window) > 1: the card beats the cpu kind at fleet level"
        ),
        "runs": runs,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
