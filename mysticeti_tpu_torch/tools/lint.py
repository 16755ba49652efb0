"""Thin CLI alias for the port's invariant checker.

The port's copy of the JAX repository's ``tools/lint.py``:

    python -m mysticeti_tpu_torch.tools.lint                  # gate: exit 1 on new findings
    python -m mysticeti_tpu_torch.tools.lint --no-baseline    # show everything
    python -m mysticeti_tpu_torch.tools.lint --baseline-regen # refresh analysis/baseline.json

Equivalent to ``python -m mysticeti_tpu_torch.analysis``; the rule catalog
is the JAX package's ``docs/static-analysis.md``.
"""
import sys

from mysticeti_tpu_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main())
