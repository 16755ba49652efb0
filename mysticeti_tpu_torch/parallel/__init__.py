"""Several devices in one verifier: mesh construction + sharded batch verification.

The counterpart of ``mysticeti_tpu.parallel``: inside one validator the
verification batch is sharded across the host's cards, pure data
parallelism over the batch axis, plus the valid count summed on the first
card.
"""
from .mesh import (
    make_mesh,
    sharded_verify_kernel,
    sharded_verify_batch,
    sharded_verify_batch_fused,
)

__all__ = [
    "make_mesh",
    "sharded_verify_kernel",
    "sharded_verify_batch",
    "sharded_verify_batch_fused",
]
