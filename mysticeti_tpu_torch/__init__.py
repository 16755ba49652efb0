"""mysticeti-tpu on PyTorch and CUDA: the committee block-signature verify path.

A port of the ``mysticeti_tpu`` verifier slice to PyTorch, with the batched
Ed25519 work running in hand-written CUDA kernels for Hopper (``sm_90a``).
It keeps the JAX package's module names and layout, so each module here has a
counterpart there, and imports nothing of it: the host modules it needs
(serde, types, committee, crypto, ...) are its own copies.

Package layout:
  types / crypto / serde / committee / threshold_clock   — block model + keys
  block_validator / verify_pipeline / validator          — the verifier seam,
                                                           hybrid router included
  verifier_service     — the shared per-host verifier service and its client
  entry / bench        — entry points, the throughput benchmark
  metrics / spans / tracing                              — observability
  runtime / utils / network                              — what the seam needs
  ops/                 — field, scalar, SHA-512 and Ed25519 in torch, plus the
                         CUDA kernel wrappers (ops/ed25519_cuda.py)
  parallel/            — the mesh of cards and the sharded dispatch
  csrc/                — the CUDA sources, built with nvcc at first use

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
