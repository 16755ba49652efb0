"""The benchmark of the PyTorch and CUDA port (``mysticeti_tpu_torch``).

One command runs one cell once (see ``run.py``)::

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); each
per-layer metric is a reader of its own (``layer_metrics/<name>.py``).  The
harness finds all three by name, so a later cell or metric adds files and
edits none.  Nothing here imports ``jax`` or the JAX package; ``reference/``
imports nothing of the port either.
"""
