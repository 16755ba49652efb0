"""Render a folded-stacks file (mysticeti_tpu_torch.profiling / stackcollapse
format) to a self-contained flamegraph SVG.

Usage:
    python -m mysticeti_tpu_torch.tools.mkflamegraph node.folded [out.svg]
    python -m mysticeti_tpu_torch.tools.mkflamegraph --diff base.folded new.folded [out.svg]

``--diff`` renders an A/B flame diff: frames laid out by the NEW profile,
colored by their share change against the BASE (red grew, blue shrank) —
the before/after view a perf-budget regression investigation starts from.

Prints the SVG's path; exits 2 with this text on stderr when the arguments
are missing.
"""
import sys

from mysticeti_tpu_torch.profiling import render_diff, render_file


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args and args[0] == "--diff":
        if len(args) < 3:
            print(__doc__, file=sys.stderr)
            return 2
        out = render_diff(args[1], args[2], args[3] if len(args) > 3 else None)
        print(out)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    out = render_file(args[0], args[1] if len(args) > 1 else None)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
