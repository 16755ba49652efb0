// Verify prologue: wire words of a signature batch -> the seven arrays the
// verify kernels consume, one thread per signature.
//
// Replaces the device code in front of both TPU kernels:
// mysticeti_tpu/ops/ed25519.py:prepare_fused (the challenge hash
// k = SHA-512(R || A || M) mod L, the 4-bit windows of s and k, the parse of
// R and A with the canonicity checks s < L and y_A < p) and
// mysticeti_tpu/ops/ed25519.py:indexed_to_msg_words (the key-table gather
// that splices A between R and M).  Outputs are bit-identical to
// prepare_fused.  A second kernel, prologue_flat, reads the flat keyed
// upload of mysticeti_tpu/ops/ed25519_pallas.py:verify_keyed_flat (96 B per
// signature, the key taken from the lane's tile, ok from a packed bitmask);
// the three layouts differ only in how a lane assembles R || A || M, s and
// its ok bit, and share prologue_core.
//
// What bounds it on Hopper: integer operations (one SHA-512 compression of
// 80 rounds per lane and a reduction mod L); its bytes (about 0.8 KB per
// lane, mostly the windows it writes) come second.  As in the verify
// kernels, a lane is one serial chain and 16,384 lanes put about one warp
// on each scheduler, so the chain's length sets the time.  Design, to keep
// that chain short:
// - native 64-bit SHA-512 words (the TPU needed hi/lo uint32 pairs), the 80
//   rounds unrolled on the card so the 16-word schedule and the state live
//   in registers (no local memory on the chain);
// - mod L by Barrett reduction on 64-bit words (HAC 14.42): a fixed sequence
//   of 34 wide products and one branch-free conditional subtract, with no
//   loop or branch that depends on the data;
// - branch-free comparisons for s < L and y < p (one borrow chain each);
// - windows and limbs written as 16-byte stores.
#include <stdint.h>

#ifndef HD
#define HD __device__ __forceinline__
#endif

// SHA-512 round constants: constant memory on the card, a static table on
// the host.
#ifdef __CUDACC__
#define PROLOGUE_CONST __constant__ const
#define PROLOGUE_UNROLL _Pragma("unroll")
#else
#define PROLOGUE_CONST static const
#define PROLOGUE_UNROLL
#endif

PROLOGUE_CONST uint64_t SHA512_K[80] = {
    0x428A2F98D728AE22ULL, 0x7137449123EF65CDULL, 0xB5C0FBCFEC4D3B2FULL, 0xE9B5DBA58189DBBCULL,
    0x3956C25BF348B538ULL, 0x59F111F1B605D019ULL, 0x923F82A4AF194F9BULL, 0xAB1C5ED5DA6D8118ULL,
    0xD807AA98A3030242ULL, 0x12835B0145706FBEULL, 0x243185BE4EE4B28CULL, 0x550C7DC3D5FFB4E2ULL,
    0x72BE5D74F27B896FULL, 0x80DEB1FE3B1696B1ULL, 0x9BDC06A725C71235ULL, 0xC19BF174CF692694ULL,
    0xE49B69C19EF14AD2ULL, 0xEFBE4786384F25E3ULL, 0x0FC19DC68B8CD5B5ULL, 0x240CA1CC77AC9C65ULL,
    0x2DE92C6F592B0275ULL, 0x4A7484AA6EA6E483ULL, 0x5CB0A9DCBD41FBD4ULL, 0x76F988DA831153B5ULL,
    0x983E5152EE66DFABULL, 0xA831C66D2DB43210ULL, 0xB00327C898FB213FULL, 0xBF597FC7BEEF0EE4ULL,
    0xC6E00BF33DA88FC2ULL, 0xD5A79147930AA725ULL, 0x06CA6351E003826FULL, 0x142929670A0E6E70ULL,
    0x27B70A8546D22FFCULL, 0x2E1B21385C26C926ULL, 0x4D2C6DFC5AC42AEDULL, 0x53380D139D95B3DFULL,
    0x650A73548BAF63DEULL, 0x766A0ABB3C77B2A8ULL, 0x81C2C92E47EDAEE6ULL, 0x92722C851482353BULL,
    0xA2BFE8A14CF10364ULL, 0xA81A664BBC423001ULL, 0xC24B8B70D0F89791ULL, 0xC76C51A30654BE30ULL,
    0xD192E819D6EF5218ULL, 0xD69906245565A910ULL, 0xF40E35855771202AULL, 0x106AA07032BBD1B8ULL,
    0x19A4C116B8D2D0C8ULL, 0x1E376C085141AB53ULL, 0x2748774CDF8EEB99ULL, 0x34B0BCB5E19B48A8ULL,
    0x391C0CB3C5C95A63ULL, 0x4ED8AA4AE3418ACBULL, 0x5B9CCA4F7763E373ULL, 0x682E6FF3D6B2B8A3ULL,
    0x748F82EE5DEFB2FCULL, 0x78A5636F43172F60ULL, 0x84C87814A1F0AB72ULL, 0x8CC702081A6439ECULL,
    0x90BEFFFA23631E28ULL, 0xA4506CEBDE82BDE9ULL, 0xBEF9A3F7B2C67915ULL, 0xC67178F2E372532BULL,
    0xCA273ECEEA26619CULL, 0xD186B8C721C0C207ULL, 0xEADA7DD6CDE0EB1EULL, 0xF57D4F7FEE6ED178ULL,
    0x06F067AA72176FBAULL, 0x0A637DC5A2C898A6ULL, 0x113F9804BEF90DAEULL, 0x1B710B35131C471BULL,
    0x28DB77F523047D84ULL, 0x32CAAB7B40C72493ULL, 0x3C9EBE0A15C9BEBCULL, 0x431D67C49C100D4CULL,
    0x4CC5D4BECB3E42B6ULL, 0x597F299CFC657E2AULL, 0x5FCB6FAB3AD6FAECULL, 0x6C44198C4A475817ULL};

HD uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

HD uint32_t bswap32(uint32_t x) {
  return (x << 24) | ((x & 0xFF00u) << 8) | ((x >> 8) & 0xFF00u) | (x >> 24);
}

HD uint64_t bswap64(uint64_t x) {
  return ((uint64_t)bswap32((uint32_t)x) << 32) | bswap32((uint32_t)(x >> 32));
}

// SHA-512 of one 96-byte message given as 24 big-endian words; the digest as
// a 512-bit little-endian integer (the Ed25519 reading of the digest bytes).
// Unrolled on the card: every index into w[] is then a constant and the
// rolling 16-word schedule stays in registers.
HD void sha512_96_le(const uint32_t msg[24], uint64_t out_le[8]) {
  const uint64_t H0[8] = {
      0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL, 0xA54FF53A5F1D36F1ULL,
      0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL, 0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};
  uint64_t w[16];
  PROLOGUE_UNROLL
  for (int t = 0; t < 12; t++) w[t] = ((uint64_t)msg[2 * t] << 32) | msg[2 * t + 1];
  w[12] = 0x8000000000000000ULL;  // padding for a 96-byte message
  w[13] = 0;
  w[14] = 0;
  w[15] = 96 * 8;
  uint64_t a = H0[0], b = H0[1], c = H0[2], d = H0[3];
  uint64_t e = H0[4], f = H0[5], g = H0[6], h = H0[7];
  PROLOGUE_UNROLL
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {  // rolling 16-word schedule
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint64_t t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) +
                        ((e & f) ^ (~e & g)) + SHA512_K[t] + w[t & 15];
    const uint64_t t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  const uint64_t st[8] = {a, b, c, d, e, f, g, h};
  // Digest bytes are the big-endian encodings of H[0..7]; read little-endian.
  PROLOGUE_UNROLL
  for (int i = 0; i < 8; i++) out_le[i] = bswap64(st[i] + H0[i]);
}

// d = a - b over N words; returns the borrow out (1 when a < b).  No branch:
// the comparisons become predicates.
template <int N>
HD uint64_t sub_words(const uint64_t* a, const uint64_t* b, uint64_t* d) {
  uint64_t borrow = 0;
  PROLOGUE_UNROLL
  for (int i = 0; i < N; i++) {
    const uint64_t t = a[i] - b[i];
    const uint64_t next = (uint64_t)(a[i] < b[i]) | (uint64_t)(t < borrow);
    d[i] = t - borrow;
    borrow = next;
  }
  return borrow;
}

HD bool geq4(const uint64_t a[4], const uint64_t b[4]) {
  uint64_t d[4];
  return sub_words<4>(a, b, d) == 0;
}

// r -= L when r >= L, branch-free.
HD void cond_sub_l(uint64_t r[4], const uint64_t L[4]) {
  uint64_t d[4];
  const uint64_t keep = (uint64_t)0 - sub_words<4>(r, L, d);  // all ones when r < L
  PROLOGUE_UNROLL
  for (int i = 0; i < 4; i++) r[i] = (r[i] & keep) | (d[i] & ~keep);
}

// The group order L in 64-bit words, and MU = floor(2^512 / L) (261 bits).
#define PROLOGUE_L {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0ULL, 0x1000000000000000ULL}
#define PROLOGUE_MU {0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL, 0xffffffffffffffebULL, \
                     0xffffffffffffffffULL, 0xfULL}

// x (512 bits, little-endian u64 words) mod L, for every x: Barrett
// reduction (HAC 14.42, base 2^64, L of k = 4 words) with the quotient
// estimate q = floor(x1 MU / 2^320), x1 = floor(x / 2^192).  Writing
// x = x1 2^192 + e and MU = 2^512 / L - f, x / L - x1 MU / 2^320 =
// e / L + f x1 / 2^320 < 2^-60 + f, and for this L, f = 0.2249...: q is
// floor(x / L) or one below it (HAC's general bound is two).  So r = x - q L,
// taken mod 2^320, lies in [0, 2L) and one conditional subtract finishes it.
// A fixed sequence: 25 wide products for q, 9 for q L mod 2^320 (a product
// with L's zero word or its power-of-two top word folds away).
HD void mod_l_512(const uint64_t x[8], uint64_t r[4]) {
  typedef unsigned __int128 u128_t;
  const uint64_t L[4] = PROLOGUE_L;
  const uint64_t MU[5] = PROLOGUE_MU;
  uint64_t q2[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  PROLOGUE_UNROLL
  for (int i = 0; i < 5; i++) {
    uint64_t carry = 0;
    PROLOGUE_UNROLL
    for (int j = 0; j < 5; j++) {
      const u128_t t = (u128_t)x[3 + i] * MU[j] + q2[i + j] + carry;
      q2[i + j] = (uint64_t)t;
      carry = (uint64_t)(t >> 64);
    }
    q2[i + 5] = carry;
  }
  // q = q2[5..9]; qL = q * L mod 2^320.
  uint64_t ql[5] = {0, 0, 0, 0, 0};
  PROLOGUE_UNROLL
  for (int i = 0; i < 5; i++) {
    uint64_t carry = 0;
    PROLOGUE_UNROLL
    for (int j = 0; i + j < 5; j++) {
      const u128_t t = (u128_t)q2[5 + i] * (j < 4 ? L[j] : 0) + ql[i + j] + carry;
      ql[i + j] = (uint64_t)t;
      carry = (uint64_t)(t >> 64);
    }
  }
  uint64_t r5[5];
  sub_words<5>(x, ql, r5);  // mod 2^320; r5[4] is 0 since r < 2L < 2^254
  PROLOGUE_UNROLL
  for (int i = 0; i < 4; i++) r[i] = r5[i];
  cond_sub_l(r, L);
}

// 256-bit value (4 LE u64 words) -> 20 x 13-bit limbs.
// On the card as 5 stores of 16 bytes (rows of 20 int32 are 80 bytes).
HD void to_limbs13(const uint64_t w[4], int32_t* out) {
  int32_t limb[20];
  PROLOGUE_UNROLL
  for (int m = 0; m < 20; m++) {
    const int bit = 13 * m, q = bit >> 6, s = bit & 63;
    uint64_t v = w[q] >> s;
    if (s > 51 && q + 1 < 4) v |= w[q + 1] << (64 - s);
    limb[m] = (int32_t)(v & 0x1FFF);
  }
#ifdef __CUDA_ARCH__
  int4* out4 = reinterpret_cast<int4*>(out);
  PROLOGUE_UNROLL
  for (int q = 0; q < 5; q++)
    out4[q] = make_int4(limb[4 * q], limb[4 * q + 1], limb[4 * q + 2], limb[4 * q + 3]);
#else
  for (int m = 0; m < 20; m++) out[m] = limb[m];
#endif
}

// 256-bit value -> 64 4-bit windows, LSB first; on the card as 16 stores of
// 16 bytes (out is 16-byte aligned: rows of 64 int32 in a fresh tensor).
HD void to_windows4(const uint64_t w[4], int32_t* out) {
#ifdef __CUDA_ARCH__
  int4* out4 = reinterpret_cast<int4*>(out);
  PROLOGUE_UNROLL
  for (int q = 0; q < 16; q++) {
    const uint64_t v = w[q >> 2] >> (16 * (q & 3));
    out4[q] = make_int4((int)(v & 15), (int)((v >> 4) & 15), (int)((v >> 8) & 15),
                        (int)((v >> 12) & 15));
  }
#else
  for (int i = 0; i < 64; i++) out[i] = (int32_t)((w[i >> 4] >> (4 * (i & 15))) & 15);
#endif
}

// 8 little-endian u32 words -> 4 u64 words.
HD void pack_le(const uint32_t le[8], uint64_t w[4]) {
  PROLOGUE_UNROLL
  for (int j = 0; j < 4; j++) w[j] = ((uint64_t)le[2 * j + 1] << 32) | le[2 * j];
}

// A point encoding given as 8 big-endian wire words: its y limbs, sign bit,
// and whether y < p.
HD bool parse_point(const uint32_t be[8], int32_t* y_limbs, int32_t* sign) {
  uint32_t le[8];
  PROLOGUE_UNROLL
  for (int j = 0; j < 8; j++) le[j] = bswap32(be[j]);
  *sign = (int32_t)(le[7] >> 31);
  le[7] &= 0x7FFFFFFFu;
  uint64_t y[4];
  pack_le(le, y);
  to_limbs13(y, y_limbs);
  const uint64_t P[4] = {0xffffffffffffffedULL, 0xffffffffffffffffULL,
                         0xffffffffffffffffULL, 0x7fffffffffffffffULL};
  return !geq4(y, P);
}

// The arithmetic every layout shares: `msg` is R || A || M as 24 big-endian
// words, `s_le` the 8 little-endian words of s.  Outputs as prepare_fused's.
HD void prologue_core(const uint32_t msg[24], const uint32_t* s_le, bool host_ok,
                      int32_t* a_y, int32_t* a_sign, int32_t* r_y,
                      int32_t* r_sign, int32_t* s_w, int32_t* k_w, uint8_t* ok) {
  uint64_t digest[8], k[4], s[4];
  sha512_96_le(msg, digest);
  mod_l_512(digest, k);
  to_windows4(k, k_w);

  parse_point(msg, r_y, r_sign);
  const bool a_canonical = parse_point(msg + 8, a_y, a_sign);

  uint32_t s_words[8];
  PROLOGUE_UNROLL
  for (int j = 0; j < 8; j++) s_words[j] = s_le[j];
  pack_le(s_words, s);
  const uint64_t L[4] = PROLOGUE_L;
  const bool s_ok = !geq4(s, L);
  to_windows4(s, s_w);
  *ok = (host_ok && a_canonical && s_ok) ? 1 : 0;
}

// R[8] and M[8] from a row, A[8] from the key table at index `key` (clipped
// to [0, num_keys) as indexed_to_msg_words clips it).
HD void splice_key(const uint32_t* rm, const uint32_t* table, int num_keys, int key,
                   uint32_t msg[24]) {
  key = key < 0 ? 0 : (key >= num_keys ? num_keys - 1 : key);
  PROLOGUE_UNROLL
  for (int j = 0; j < 8; j++) {
    msg[j] = rm[j];
    msg[8 + j] = table[8 * key + j];
    msg[16 + j] = rm[8 + j];
  }
}

// One lane.  `row` is the lane's blob row: the indexed layout (26 words:
// R[8] M[8] s[8] key ok) when `table` is given, else the raw layout
// (33 words: R[8] A[8] M[8] s[8] ok).
HD void prologue_lane(const uint32_t* row, const uint32_t* table, int num_keys,
                      int32_t* a_y, int32_t* a_sign, int32_t* r_y,
                      int32_t* r_sign, int32_t* s_w, int32_t* k_w,
                      uint8_t* ok) {
  uint32_t msg[24];
  if (table != 0) {
    splice_key(row, table, num_keys, (int)row[24], msg);
    prologue_core(msg, row + 16, row[25] != 0, a_y, a_sign, r_y, r_sign, s_w, k_w, ok);
  } else {
    PROLOGUE_UNROLL
    for (int j = 0; j < 24; j++) msg[j] = row[j];
    prologue_core(msg, row + 24, row[32] != 0, a_y, a_sign, r_y, r_sign, s_w, k_w, ok);
  }
}

// One lane of the flat layout (replaces the XLA steps of
// mysticeti_tpu/ops/ed25519_pallas.py:_verify_keyed_flat_jit): `row` is the
// lane's 24 words R[8] M[8] s[8]; its key is its tile's, and its ok bit lane
// i of the packed little-bit-order mask that follows the B rows.
HD void prologue_flat_lane(const uint32_t* row, const uint32_t* table, int num_keys,
                           int key, bool host_ok, int32_t* a_y, int32_t* a_sign,
                           int32_t* r_y, int32_t* r_sign, int32_t* s_w, int32_t* k_w,
                           uint8_t* ok) {
  uint32_t msg[24];
  splice_key(row, table, num_keys, key, msg);
  prologue_core(msg, row + 16, host_ok, a_y, a_sign, r_y, r_sign, s_w, k_w, ok);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// 64 threads a block: 16,384 lanes are 256 blocks over the 132 SMs, and a
// 256-lane flush spreads over 4 SMs.
#define PROLOGUE_THREADS 64

__global__ void __launch_bounds__(PROLOGUE_THREADS)
prologue_kernel(const uint32_t* __restrict__ blob, int ncols,
                const uint32_t* __restrict__ table, int num_keys, int32_t* a_y,
                int32_t* a_sign, int32_t* r_y, int32_t* r_sign, int32_t* s_w,
                int32_t* k_w, uint8_t* ok, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  prologue_lane(blob + (size_t)ncols * i, table, num_keys, a_y + 20 * i,
                a_sign + i, r_y + 20 * i, r_sign + i, s_w + 64 * i, k_w + 64 * i,
                ok + i);
}

extern "C" int prologue_launch(const void* blob, int ncols, const void* table,
                               int num_keys, void* a_y, void* a_sign, void* r_y,
                               void* r_sign, void* s_w, void* k_w, void* ok,
                               int n, void* stream) {
  const int threads = PROLOGUE_THREADS;
  const int blocks = (n + threads - 1) / threads;
  prologue_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blob, ncols, (const uint32_t*)table, num_keys,
      (int32_t*)a_y, (int32_t*)a_sign, (int32_t*)r_y, (int32_t*)r_sign,
      (int32_t*)s_w, (int32_t*)k_w, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

// flat: n * 24 row words, then n / 32 mask words.  Lane i's key is
// tile_keys[i / tile].
__global__ void __launch_bounds__(PROLOGUE_THREADS)
prologue_flat_kernel(const uint32_t* __restrict__ flat,
                     const uint32_t* __restrict__ table, int num_keys,
                     const int32_t* __restrict__ tile_keys, int tile, int32_t* a_y,
                     int32_t* a_sign, int32_t* r_y, int32_t* r_sign, int32_t* s_w,
                     int32_t* k_w, uint8_t* ok, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool host_ok = (flat[(size_t)24 * n + (i >> 5)] >> (i & 31)) & 1u;
  prologue_flat_lane(flat + (size_t)24 * i, table, num_keys, tile_keys[i / tile], host_ok,
                     a_y + 20 * i, a_sign + i, r_y + 20 * i, r_sign + i, s_w + 64 * i,
                     k_w + 64 * i, ok + i);
}

extern "C" int prologue_flat_launch(const void* flat, const void* table, int num_keys,
                                    const void* tile_keys, int tile, void* a_y,
                                    void* a_sign, void* r_y, void* r_sign, void* s_w,
                                    void* k_w, void* ok, int n, void* stream) {
  const int threads = PROLOGUE_THREADS;
  const int blocks = (n + threads - 1) / threads;
  prologue_flat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)flat, (const uint32_t*)table, num_keys, (const int32_t*)tile_keys,
      tile, (int32_t*)a_y, (int32_t*)a_sign, (int32_t*)r_y, (int32_t*)r_sign,
      (int32_t*)s_w, (int32_t*)k_w, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}
#endif
