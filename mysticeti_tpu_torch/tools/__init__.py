"""Command-line tools of the port, each run as ``python -m
mysticeti_tpu_torch.tools.<name>``.

Their default outputs (artifacts, the trend index) lie under the checkout's
``build/``, which git ignores: the repository root holds the JAX package's
rounds, which the port's tools never write."""
from __future__ import annotations

import json
import os
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO, "build")


def build_path(name: str) -> str:
    """``name`` under the checkout's ``build/``."""
    return os.path.join(BUILD_DIR, name)


def write_json(path: str, doc, **dump_kwargs) -> None:
    """Write ``doc`` to ``path`` (its directory made first) through a
    temporary file, with a trailing newline."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, **dump_kwargs)
        f.write("\n")
    os.replace(tmp, path)


def card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no card (or no ``nvidia-smi``)."""
    from ..bench import card_line

    line = card_line()
    return None if line.startswith("nvidia-smi unavailable") else line


def node_kind(verifier: str) -> str:
    """The kind a tool's validators run for its ``verifier``: the JAX tools'
    fleets and live validators run the ``cpu`` kind where their sims run the
    re-sign oracle (``sim-oracle``)."""
    return "cpu" if verifier == "sim-oracle" else verifier


def launch_counts(warmup: bool = False) -> dict:
    """Every kernel wrapper's launch count in this process; with ``warmup``,
    those of its launches made inside a verifier's warm-up
    (``Kernel.warmup_launches``)."""
    from ..ops import ed25519_cuda as K

    return {k.name: k.warmup_launches if warmup else k.launches for k in K.KERNELS}


def warmups_since(before: dict) -> dict:
    """The warm-up launches in this process since ``before`` (a
    ``launch_counts(warmup=True)``)."""
    return {k: v - before.get(k, 0) for k, v in launch_counts(warmup=True).items()}


def launches_since(before: dict, warmups_before: Optional[dict] = None) -> dict:
    """Every kernel wrapper's launches in this process since ``before`` (a
    ``launch_counts()``); with ``warmups_before`` (a
    ``launch_counts(warmup=True)`` taken with it), less the warm-up launches
    since then.  In-process validators warm their verifiers as they boot,
    beside the others' flushes, so a window's launches less these are its
    flushes'."""
    out = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    if warmups_before is not None:
        for k, v in warmups_since(warmups_before).items():
            out[k] -= v
    return out
