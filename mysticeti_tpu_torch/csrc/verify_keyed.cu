// Keyed-tile batched Ed25519 verify: every block's lanes share one committee key.
//
// Replaces the TPU kernel mysticeti_tpu/ops/ed25519_pallas.py:_verify_keyed_pallas_jit
// (body _verify_keyed_body).  The host groups signatures by key
// (ops/ed25519.py:group_blob_for_tiles) so that block b serves tile b, whose
// key is tile_keys[b]; that key's negated comb -(v * 16^w * A) was built once
// per committee (build_neg_key_combs).  [s]B + [k](-A) is then 128 Niels
// mixed adds: no doublings and no decompression of A.
//
// What bounds it on Hopper: integer multiplies (about 1,200 field multiplies
// of 25 wide products per lane).  Design: the TPU's scalar-prefetched comb
// DMA becomes a per-block key read; the comb stays in global memory / L2
// (12 MB for a 50-key committee) and each lane loads its own entry by index.
#include "fe51.cuh"

// Inputs as in verify_generic.cu; key_comb is the (64, 3, 20, 16) comb of
// this lane's key.  Lanes under an invalid key are rejected by the host
// (their ok bit is cleared before grouping).
HD bool verify_keyed_lane(const int32_t* comb, const int32_t* key_comb,
                          const int32_t* r_y, int r_sign, const int32_t* s_w,
                          const int32_t* k_w) {
  ge acc = ge_identity();
  for (int i = 0; i < 64; i++) {
    acc = ge_madd(acc, gn_load(comb + i * 3 * 20 * 16, s_w[i]));
    acc = ge_madd(acc, gn_load(key_comb + i * 3 * 20 * 16, k_w[i]));
  }
  return ge_matches(acc, r_y, r_sign);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void verify_keyed_kernel(const int32_t* __restrict__ comb,
                                    const int32_t* __restrict__ acomb,
                                    const int32_t* __restrict__ tile_keys,
                                    const int32_t* __restrict__ r_y,
                                    const int32_t* __restrict__ r_sign,
                                    const int32_t* __restrict__ s_w,
                                    const int32_t* __restrict__ k_w,
                                    const uint8_t* __restrict__ ok,
                                    uint8_t* __restrict__ out, int num_keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // grid covers B exactly
  int key = tile_keys[blockIdx.x];
  key = key < 0 ? 0 : (key >= num_keys ? num_keys - 1 : key);
  bool res = false;
  if (ok[i]) {
    res = verify_keyed_lane(comb, acomb + (size_t)key * 64 * 3 * 20 * 16,
                            r_y + 20 * i, r_sign[i], s_w + 64 * i, k_w + 64 * i);
  }
  out[i] = res ? 1 : 0;
}

extern "C" int verify_keyed_launch(const void* comb, const void* acomb,
                                   const void* tile_keys, const void* r_y,
                                   const void* r_sign, const void* s_w,
                                   const void* k_w, const void* ok, void* out,
                                   int n, int tile, int num_keys, void* stream) {
  verify_keyed_kernel<<<n / tile, tile, 0, (cudaStream_t)stream>>>(
      (const int32_t*)comb, (const int32_t*)acomb, (const int32_t*)tile_keys,
      (const int32_t*)r_y, (const int32_t*)r_sign, (const int32_t*)s_w,
      (const int32_t*)k_w, (const uint8_t*)ok, (uint8_t*)out, num_keys);
  return (int)cudaGetLastError();
}
#endif
