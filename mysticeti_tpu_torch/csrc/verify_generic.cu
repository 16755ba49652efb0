// Generic batched Ed25519 verify, one thread per signature.
//
// Replaces the TPU kernel mysticeti_tpu/ops/ed25519_pallas.py:_verify_pallas_jit
// (body _verify_body): cofactorless check that encode([s]B + [k](-A)) equals
// the raw R bytes, ANDed with A's decompression bit and the prologue's ok bit.
//
//   decompress A, negate it; build 1..8 times -A in cached form, in shared
//   memory; recode k's 64 windows to signed digits in [-8, 8]; 64 windows MSB
//   first: 4 doublings + one table add (the entry negated for a negative
//   digit, none for a zero digit) for [k](-A), and one Niels mixed add from
//   the 51-bit base comb for [s]B; combine, invert Z, compare.
//
// What bounds it on Hopper: the serial chain of one lane's field operations
// (about 1,530 squarings and 1,800 multiplies, each 25 wide products
// emulated in 32-bit multiply-adds).  The card runs one warp per scheduler at
// 16,384 lanes, so nothing hides the chain's latency, and every gather that
// stalls it adds to the time: one lane alone takes as long as 256 lanes.
// Design, for the memory the lane reads:
// - the table of -A lives in dynamic shared memory, 8 entries of 4 x 5
//   limbs (1,280 B a lane), interleaved by thread (limb row r of thread t at
//   [r * blockDim.x + t]) so a warp's 64-bit reads at per-lane entries are
//   free of bank conflicts, and every window's read stays on the SM;
// - the base comb is read in 5 x 51-bit limbs, one 128-byte line per entry
//   (ops/ed25519.py base_comb51), as eight 16-byte read-only loads;
// - like the TPU kernel, no T where nothing reads it: three of each window's
//   four doublings and every window add but the last emit X, Y, Z only.
// Launch shape: 64 threads a block, 80 KB of dynamic shared memory (set with
// cudaFuncAttributeMaxDynamicSharedMemorySize at every launch, on the current
// device).  Two such blocks fit an SM's 228 KB (a third does not), the same
// 128 lanes a SM as one block of 128 threads (160 KB), but a small batch
// spreads over twice the SMs; 16,384 lanes are 256 blocks, one wave over
// 132 SMs x 2.  ptxas (sm_90a, CUDA 12.8): 246 registers, 0 B stack, no
// spills.
#include "fe51.cuh"

#define GENERIC_THREADS 64
// One lane's table: 8 entries x 4 coordinates x 5 limbs of 8 bytes.
#define GENERIC_TAB_BYTES (8 * 4 * 5 * 8)

// Limb l of coordinate c of entry e sits at tab[((e * 4 + c) * 5 + l) * stride].
HD void fe_store(uint64_t* tab, int stride, int row, const fe& a) {
  for (int l = 0; l < 5; l++) tab[(row + l) * stride] = a.v[l];
}

HD fe fe_load(const uint64_t* tab, int stride, int row) {
  fe r;
  for (int l = 0; l < 5; l++) r.v[l] = tab[(row + l) * stride];
  return r;
}

HD void gc_store(uint64_t* tab, int stride, int e, const gc& q) {
  fe_store(tab, stride, (e * 4 + 0) * 5, q.ymx);
  fe_store(tab, stride, (e * 4 + 1) * 5, q.ypx);
  fe_store(tab, stride, (e * 4 + 2) * 5, q.z2);
  fe_store(tab, stride, (e * 4 + 3) * 5, q.t2d);
}

// Entry e, negated when neg: -(Y-X, Y+X, 2Z, 2dT) = (Y+X, Y-X, 2Z, -2dT).
HD gc gc_load(const uint64_t* tab, int stride, int e, bool neg) {
  gc q;
  q.ymx = fe_load(tab, stride, (e * 4 + (neg ? 1 : 0)) * 5);
  q.ypx = fe_load(tab, stride, (e * 4 + (neg ? 0 : 1)) * 5);
  q.z2 = fe_load(tab, stride, (e * 4 + 2) * 5);
  q.t2d = fe_load(tab, stride, (e * 4 + 3) * 5);
  if (neg) q.t2d = fe_neg(q.t2d);
  return q;
}

// The projective point of a cached entry: (Y+X) - (Y-X) = 2X, (Y+X) + (Y-X)
// = 2Y and 2Z.  T is left zero: only a doubling, which never reads it, may
// follow.
HD ge ge_from_cached(const gc& q) {
  ge r;
  r.X = fe_sub(q.ypx, q.ymx);
  r.Y = fe_add(q.ypx, q.ymx);
  r.Z = q.z2;
  r.T = fe_zero();
  return r;
}

// Signed recoding of k's 4-bit windows w_j (LSB first, only their low 4 bits
// read): d_j = w_j + c_j - 16 c_{j+1} in [-8, 8], where c_{j+1} = (w_j + c_j >
// 8) carries out of window j, c_0 = 0.  Returns the carries as a mask, bit j
// = c_{j+1}, so that k = sum d_j 16^j + c_64 16^64 for any windows.  c_64 is
// 0 for every k below 2^255, so for every k the prologue gives (k < L); the
// ladder takes it as a 65th digit all the same.
HD uint64_t recode_carries(const int32_t* k_w) {
  uint64_t mask = 0;
  int c = 0;
  for (int j = 0; j < 64; j++) {
    c = (k_w[j] & 15) + c > 8 ? 1 : 0;
    mask |= (uint64_t)c << j;
  }
  return mask;
}

HD int recode_digit(const int32_t* k_w, uint64_t carries, int j) {
  const int c_in = j > 0 ? (int)((carries >> (j - 1)) & 1) : 0;
  return (k_w[j] & 15) + c_in - 16 * (int)((carries >> j) & 1);
}

// Inputs are batch-major, in the 13-bit limb layout of the port's public
// functions: a_y/r_y (B, 20), a_sign/r_sign (B,), s_w/k_w (B, 64) 4-bit
// windows LSB first, ok (B,) bytes; comb51 (64, 16, 16) uint64.  out (B,)
// bytes.  tab is the lane's table storage, entry rows `stride` apart: the
// thread's slot of shared memory on the device, a local array on the host.
HD bool verify_generic_lane(const uint64_t* comb51, const int32_t* a_y, int a_sign,
                            const int32_t* r_y, int r_sign, const int32_t* s_w,
                            const int32_t* k_w, uint64_t* tab, int stride) {
  ge p;
  const bool dec_ok = ge_decompress(fe_from13(a_y, 1), a_sign, p);
  p.X = fe_neg(p.X);
  p.T = fe_neg(p.T);
  const gc neg_a = ge_to_cached(p);
  gc_store(tab, stride, 0, neg_a);
  for (int e = 1; e < 8; e++) {
    p = ge_add_cached(p, neg_a);  // (e + 1) * -A
    gc_store(tab, stride, e, ge_to_cached(p));
  }

  const uint64_t carries = recode_carries(k_w);
  ge acc_a = ge_identity(), acc_b = ge_identity();
  // c_64 = 1: the digit above the top window is 1, so the ladder starts at -A.
  if (carries >> 63) acc_a = ge_from_cached(gc_load(tab, stride, 0, false));
  for (int i = 0; i < 64; i++) {
    const bool last = i == 63;  // the combine reads acc_a's T
    const int d = recode_digit(k_w, carries, 63 - i);
    acc_a = ge_double(ge_double(ge_double(acc_a, false), false), false);
    acc_a = ge_double(acc_a, d != 0 || last);
    if (d != 0) acc_a = ge_add_cached(acc_a, gc_load(tab, stride, (d < 0 ? -d : d) - 1, d < 0), last);
    acc_b = ge_madd(acc_b, gn_load51(comb51 + (i * 16 + (s_w[i] & 15)) * 16));
  }
  return ge_matches(ge_add(acc_a, acc_b), r_y, r_sign) && dec_ok;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(GENERIC_THREADS)
verify_generic_kernel(const uint64_t* __restrict__ comb51,
                      const int32_t* __restrict__ a_y,
                      const int32_t* __restrict__ a_sign,
                      const int32_t* __restrict__ r_y,
                      const int32_t* __restrict__ r_sign,
                      const int32_t* __restrict__ s_w,
                      const int32_t* __restrict__ k_w,
                      const uint8_t* __restrict__ ok,
                      uint8_t* __restrict__ out, int n) {
  extern __shared__ uint64_t tab[];  // each thread reads only its own slot
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool res = false;
  if (ok[i]) {
    res = verify_generic_lane(comb51, a_y + 20 * i, a_sign[i], r_y + 20 * i, r_sign[i],
                              s_w + 64 * i, k_w + 64 * i, tab + threadIdx.x, blockDim.x);
  }
  out[i] = res ? 1 : 0;
}

extern "C" void verify_generic_shape(int* threads, int* smem_bytes) {
  *threads = GENERIC_THREADS;
  *smem_bytes = GENERIC_THREADS * GENERIC_TAB_BYTES;
}

extern "C" int verify_generic_launch(const void* comb51, const void* a_y,
                                     const void* a_sign, const void* r_y,
                                     const void* r_sign, const void* s_w,
                                     const void* k_w, const void* ok, void* out,
                                     int n, void* stream) {
  const int smem = GENERIC_THREADS * GENERIC_TAB_BYTES;
  // Above 48 KB a block's dynamic shared memory must be allowed per kernel,
  // and the attribute belongs to the current device's context.
  cudaError_t err = cudaFuncSetAttribute(
      verify_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported again later
    return (int)err;
  }
  const int blocks = (n + GENERIC_THREADS - 1) / GENERIC_THREADS;
  verify_generic_kernel<<<blocks, GENERIC_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)comb51, (const int32_t*)a_y, (const int32_t*)a_sign,
      (const int32_t*)r_y, (const int32_t*)r_sign, (const int32_t*)s_w,
      (const int32_t*)k_w, (const uint8_t*)ok, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
