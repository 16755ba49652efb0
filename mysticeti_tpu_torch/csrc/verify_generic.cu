// Generic batched Ed25519 verify, one thread per signature.
//
// Replaces the TPU kernel mysticeti_tpu/ops/ed25519_pallas.py:_verify_pallas_jit
// (body _verify_body): cofactorless check that encode([s]B + [k](-A)) equals
// the raw R bytes, ANDed with A's decompression bit and the prologue's ok bit.
//
//   decompress A, negate it; build the 16 multiples of -A (local memory);
//   64 windows MSB first: 4 doublings + one table add for [k](-A), and one
//   Niels mixed add from the base comb for [s]B; combine, invert Z, compare.
//
// What bounds it on Hopper: integer multiplies (about 3,700 field multiplies
// of 25 wide products per lane).  Design: 5 x 51-bit limbs (fe51.cuh) to use
// the 64-bit multiplier; the one-hot selects of the TPU kernel (_gather16,
// _gather_comb) become indexed loads, since the indices are public; the base
// comb (240 KiB) is read from global memory, where it stays in L2.
#include "fe51.cuh"

// Inputs are batch-major, in the 13-bit limb layout of the port's public
// functions: a_y/r_y (B, 20), a_sign/r_sign (B,), s_w/k_w (B, 64) 4-bit
// windows LSB first, ok (B,) bytes; comb (64, 3, 20, 16).  out (B,) bytes.
HD bool verify_generic_lane(const int32_t* comb, const int32_t* a_y, int a_sign,
                            const int32_t* r_y, int r_sign, const int32_t* s_w,
                            const int32_t* k_w) {
  ge a;
  const bool dec_ok = ge_decompress(fe_from13(a_y, 1), a_sign, a);
  ge neg_a = a;
  neg_a.X = fe_neg(a.X);
  neg_a.T = fe_neg(a.T);
  ge tab[16];
  tab[0] = ge_identity();
  tab[1] = neg_a;
  for (int v = 2; v < 16; v++) tab[v] = ge_add(tab[v - 1], neg_a);

  ge acc_a = ge_identity(), acc_b = ge_identity();
  for (int i = 0; i < 64; i++) {
    acc_a = ge_double(ge_double(ge_double(ge_double(acc_a))));
    acc_a = ge_add(acc_a, tab[k_w[63 - i]]);
    acc_b = ge_madd(acc_b, gn_load(comb + i * 3 * 20 * 16, s_w[i]));
  }
  return ge_matches(ge_add(acc_a, acc_b), r_y, r_sign) && dec_ok;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void verify_generic_kernel(const int32_t* __restrict__ comb,
                                      const int32_t* __restrict__ a_y,
                                      const int32_t* __restrict__ a_sign,
                                      const int32_t* __restrict__ r_y,
                                      const int32_t* __restrict__ r_sign,
                                      const int32_t* __restrict__ s_w,
                                      const int32_t* __restrict__ k_w,
                                      const uint8_t* __restrict__ ok,
                                      uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool res = false;
  if (ok[i]) {
    res = verify_generic_lane(comb, a_y + 20 * i, a_sign[i], r_y + 20 * i,
                              r_sign[i], s_w + 64 * i, k_w + 64 * i);
  }
  out[i] = res ? 1 : 0;
}

extern "C" int verify_generic_launch(const void* comb, const void* a_y,
                                     const void* a_sign, const void* r_y,
                                     const void* r_sign, const void* s_w,
                                     const void* k_w, const void* ok, void* out,
                                     int n, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  verify_generic_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)comb, (const int32_t*)a_y, (const int32_t*)a_sign,
      (const int32_t*)r_y, (const int32_t*)r_sign, (const int32_t*)s_w,
      (const int32_t*)k_w, (const uint8_t*)ok, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
