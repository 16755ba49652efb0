// Keyed batched Ed25519 verify: every signature's key is a committee key
// whose negated comb was built once per committee.
//
// Replaces the TPU kernel mysticeti_tpu/ops/ed25519_pallas.py:_verify_keyed_pallas_jit
// (body _verify_keyed_body): [s]B + [k](-A) as 128 Niels mixed adds, 64 from
// the base comb and 64 from the key's comb -(v * 16^w * A)
// (build_neg_key_combs); no doublings and no decompression of A.
//
// What bounds it on Hopper: integer multiplies (909 field multiplies and
// squarings of 25 wide products per lane), in one serial chain a lane.
// Design, for how a lane finds its key and reads its combs:
// - one key per lane: lane i reads keys[i / tile], clipped to [0, K).  The
//   TPU grid fetched one key's comb per 32-lane tile by scalar prefetch, so
//   the host had to group lanes by key, and a 256-signature flush of a
//   50-key committee (50 tiles, 8 in the bucket) never grouped.  Here a lane
//   gathers its own key's entries: tile = 1 takes the keys in natural order
//   (verify_keyed_lanes), tile = 32 the grouped tiles (verify_keyed);
// - both combs in 5 x 51-bit limbs, one 128-byte line per (window, entry),
//   read as eight 16-byte loads (gn_load51): no 13 -> 51-bit repacking, and
//   a 50-key committee's combs (6.55 MB) stay in the 50 MB L2;
// - any block size; the grid masks the ragged edge.
#include "fe51.cuh"

#define KEYED_THREADS 64

// Inputs as in verify_generic.cu; comb51 is the (64, 16, 16) base comb and
// key_comb51 the (64, 16, 16) comb of this lane's key.  Lanes under an
// invalid key are rejected by the host (their ok bit is cleared).
// Each window's two comb lines are loaded one window ahead, so that their
// latency (a window read, then a 128-byte line from L2) overlaps the
// previous window's adds instead of stalling the chain.
HD bool verify_keyed_lane(const uint64_t* comb51, const uint64_t* key_comb51,
                          const int32_t* r_y, int r_sign, const int32_t* s_w,
                          const int32_t* k_w) {
  gn b = gn_load51(comb51 + (s_w[0] & 15) * 16);
  gn a = gn_load51(key_comb51 + (k_w[0] & 15) * 16);
  ge acc = ge_identity();
  for (int i = 0; i < 64; i++) {
    const int j = i < 63 ? i + 1 : 63;  // the last window reads its own lines again
    const gn b_next = gn_load51(comb51 + (j * 16 + (s_w[j] & 15)) * 16);
    const gn a_next = gn_load51(key_comb51 + (j * 16 + (k_w[j] & 15)) * 16);
    acc = ge_madd(acc, b);
    acc = ge_madd(acc, a);
    b = b_next;
    a = a_next;
  }
  return ge_matches(acc, r_y, r_sign);
}

// The comb of lane i's key, keys[i / tile] clipped to [0, num_keys) (-1, the
// unknown-key sentinel, becomes 0).
HD const uint64_t* keyed_lane_comb(const uint64_t* acomb51, const int32_t* keys, int tile,
                                   int num_keys, int i) {
  int key = keys[i / tile];
  key = key < 0 ? 0 : (key >= num_keys ? num_keys - 1 : key);
  return acomb51 + (size_t)key * 64 * 16 * 16;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(KEYED_THREADS)
verify_keyed_kernel(const uint64_t* __restrict__ comb51,
                    const uint64_t* __restrict__ acomb51,
                    const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ r_y,
                    const int32_t* __restrict__ r_sign,
                    const int32_t* __restrict__ s_w,
                    const int32_t* __restrict__ k_w,
                    const uint8_t* __restrict__ ok,
                    uint8_t* __restrict__ out, int n, int tile, int num_keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool res = false;
  if (ok[i]) {
    res = verify_keyed_lane(comb51, keyed_lane_comb(acomb51, keys, tile, num_keys, i),
                            r_y + 20 * i, r_sign[i], s_w + 64 * i, k_w + 64 * i);
  }
  out[i] = res ? 1 : 0;
}

extern "C" int verify_keyed_launch(const void* comb51, const void* acomb51,
                                   const void* keys, const void* r_y,
                                   const void* r_sign, const void* s_w,
                                   const void* k_w, const void* ok, void* out,
                                   int n, int tile, int num_keys, void* stream) {
  const int blocks = (n + KEYED_THREADS - 1) / KEYED_THREADS;
  verify_keyed_kernel<<<blocks, KEYED_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)comb51, (const uint64_t*)acomb51, (const int32_t*)keys,
      (const int32_t*)r_y, (const int32_t*)r_sign, (const int32_t*)s_w,
      (const int32_t*)k_w, (const uint8_t*)ok, (uint8_t*)out, n, tile, num_keys);
  return (int)cudaGetLastError();
}
#endif
