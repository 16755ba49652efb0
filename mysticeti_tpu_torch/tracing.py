"""Module loggers: the part of ``mysticeti_tpu.tracing`` the verifier needs.

The env-filtered handler setup and the simulator's virtual-time formatter are
not carried over; the port's modules log through the standard ``logging``
tree under ``mysticeti_tpu_torch``.
"""
from __future__ import annotations

import logging


def logger(name: str) -> logging.Logger:
    """Module logger factory: ``logger(__name__)``."""
    return logging.getLogger(name)
