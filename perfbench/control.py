"""The control of ``correct``: the plain reference put in the place of the
layer under test (stage 2, the signature verifier), with one guarantee of
the configuration broken: it accepts every block whose structure is sound
and checks no signature.  Every other part of a run is the benchmark's own,
so the comparison has to come out not correct (the forged blocks).

    python3 -m perfbench.control --workload c50-catchup --seconds 10 --seeds 11 12 13

One JSON line a seed with the numbers compared.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json

from .reference.blocks import decode, structure_ok
from .run import load_cell, log, run_cell, setup_env


class StructureOnly:
    """Stage 2 as the reference without its signature check."""

    def __init__(self, committee_size: int, epoch: int) -> None:
        self.n, self.epoch = committee_size, epoch

    async def verify_blocks(self, blocks):
        return [structure_ok(decode(b.to_bytes()), self.n, self.epoch) for b in blocks]


def patch_for(cell):
    def patch(rx) -> None:
        rx.verifier = StructureOnly(int(cell.config["committee_size"]), int(cell.config.get("epoch", 0)))

    return patch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    setup_env()
    cell = load_cell(args.workload)
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, kind="accept", patch=patch_for(cell))
        checks = {k: v["value"] for k, v in out["checks"].items()}
        correct = all(v["value"] <= v["limit"] for v in out["checks"].values())
        print(json.dumps({"workload": cell.name, "seed": seed, "control": True,
                          "correct": correct, "blocks": out["window"].blocks, **checks}), flush=True)
        log(f"control seed {seed}: correct {correct}, {checks}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
