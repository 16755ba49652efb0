"""The port's copy of ``mysticeti_tpu.network``, trimmed to what the verifier
needs: the jittered backoff that the hybrid router's circuit breaker uses to
schedule its probes.  The mesh transport itself is not carried over yet.
"""
from __future__ import annotations

import random


def jittered_backoff(delay: float, rng: random.Random) -> float:
    """Uniform [0.5, 1.5)x jitter around an exponential-backoff delay.

    A bare doubling schedule synchronizes reconnect storms: every dialer that
    lost the same peer at the same moment retries on the same beat, hammering
    the recovering node in lockstep bursts.  The multiplicative jitter keeps
    the expected delay while decorrelating the fleet; callers pass a SEEDED
    rng so simulated runs stay reproducible.
    """
    return delay * (0.5 + rng.random())
