"""Torch and CUDA kernels for the block-verification hot path.

Modules:
  field         — GF(2^255-19) arithmetic in 20 x 13-bit limbs (plain torch)
  scalar        — mod-L reduction, windows and word plumbing (plain torch)
  sha512        — SHA-512 of the 96-byte R || A || M (plain torch)
  ed25519       — the plain verify pieces, packers, KeyTable and dispatch
  ed25519_cuda  — the CUDA kernel wrappers (prologue, generic, keyed)
  cuda_build    — nvcc build and ctypes loading of csrc/
"""
