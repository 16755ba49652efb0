// GF(2^255-19) and Edwards25519 point arithmetic for the Hopper verify kernels.
//
// Representation: 5 x 51-bit limbs in uint64_t, products in unsigned __int128.
// The TPU kernels (mysticeti_tpu/ops/ed25519_pallas.py) use 20 x 13-bit int32
// limbs because the TPU has no 64-bit multiplier; Hopper has mul.wide/mul.hi
// and 64-bit adds, so a field multiply here is 25 wide products instead of
// 400 narrow ones.  The kernels' inputs and outputs stay in the 13-bit limb
// layout of the port's public functions; fe_from13 converts at the boundary.
// The combs the kernels read (the base comb, the keyed kernel's key combs)
// come in 51-bit limbs, one 128-byte line per entry (gn_load51).
//
// Invariant ("carried"): every fe handed to a public function below has limbs
// < 2^52.  fe_add/fe_sub/fe_mul return carried values.
//
// Functions are declared through HD: device functions under nvcc; defining
// HD first (for example as `static inline`) compiles the same arithmetic for
// the host with a C++ compiler.
#pragma once
#include <stdint.h>

#ifndef HD
#define HD __device__ __forceinline__
#endif

// Hooks a host build may define to count the field squarings and multiplies
// a lane does (ops/ed25519_cuda.py reckons the kernels' bounds on the same
// count); empty otherwise.
#ifndef FE_COUNT_SQ
#define FE_COUNT_SQ()
#endif
#ifndef FE_COUNT_MUL
#define FE_COUNT_MUL()
#endif

typedef unsigned __int128 u128;

#define FE_MASK51 ((1ULL << 51) - 1)

struct fe { uint64_t v[5]; };
struct ge { fe X, Y, Z, T; };     // extended coordinates: x = X/Z, y = Y/Z, xy = T/Z
struct gn { fe ymx, ypx, t2d; };  // Niels form of an affine point: (y-x, y+x, 2d*x*y)
struct gc { fe ymx, ypx, z2, t2d; };  // cached form of a ge: (Y-X, Y+X, 2Z, 2d*T)

HD fe fe_const(uint64_t a, uint64_t b, uint64_t c, uint64_t d, uint64_t e) {
  fe r; r.v[0] = a; r.v[1] = b; r.v[2] = c; r.v[3] = d; r.v[4] = e; return r;
}
HD fe fe_zero() { return fe_const(0, 0, 0, 0, 0); }
HD fe fe_one() { return fe_const(1, 0, 0, 0, 0); }
HD fe fe_d() {
  return fe_const(0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
                  0x739c663a03cbbULL, 0x52036cee2b6ffULL);
}
HD fe fe_d2() {
  return fe_const(0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
                  0x6738cc7407977ULL, 0x2406d9dc56dffULL);
}
HD fe fe_sqrt_m1() {
  return fe_const(0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
                  0x78595a6804c9eULL, 0x2b8324804fc1dULL);
}

// Weak reduction: limbs back below 2^51 (limb 0 below 2^51 + 19*2^13).
HD void fe_carry(fe& r) {
  uint64_t c;
  c = r.v[0] >> 51; r.v[0] &= FE_MASK51; r.v[1] += c;
  c = r.v[1] >> 51; r.v[1] &= FE_MASK51; r.v[2] += c;
  c = r.v[2] >> 51; r.v[2] &= FE_MASK51; r.v[3] += c;
  c = r.v[3] >> 51; r.v[3] &= FE_MASK51; r.v[4] += c;
  c = r.v[4] >> 51; r.v[4] &= FE_MASK51; r.v[0] += 19 * c;
}

HD fe fe_add(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
  fe_carry(r);
  return r;
}

// a - b + 4p: 4p's limbs exceed any carried limb, so nothing goes negative.
HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = a.v[0] + 0x1fffffffffffb4ULL - b.v[0];
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + 0x1ffffffffffffcULL - b.v[i];
  fe_carry(r);
  return r;
}

HD fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

HD fe fe_product(const fe& a, const fe& b) {
  const uint64_t a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const uint64_t b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  const uint64_t b1_19 = 19 * b1, b2_19 = 19 * b2, b3_19 = 19 * b3, b4_19 = 19 * b4;
  // Inputs < 2^52, 19*b < 2^57: each product < 2^109, each sum < 2^112.
  u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 + (u128)a3 * b2_19 + (u128)a4 * b1_19;
  u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 + (u128)a3 * b3_19 + (u128)a4 * b2_19;
  u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 + (u128)a3 * b4_19 + (u128)a4 * b3_19;
  u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 + (u128)a3 * b0 + (u128)a4 * b4_19;
  u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 + (u128)a3 * b1 + (u128)a4 * b0;
  fe r;
  t1 += (uint64_t)(t0 >> 51); r.v[0] = (uint64_t)t0 & FE_MASK51;
  t2 += (uint64_t)(t1 >> 51); r.v[1] = (uint64_t)t1 & FE_MASK51;
  t3 += (uint64_t)(t2 >> 51); r.v[2] = (uint64_t)t2 & FE_MASK51;
  t4 += (uint64_t)(t3 >> 51); r.v[3] = (uint64_t)t3 & FE_MASK51;
  r.v[4] = (uint64_t)t4 & FE_MASK51;
  u128 c = (u128)r.v[0] + (u128)(uint64_t)(t4 >> 51) * 19;  // t4 >> 51 < 2^62
  r.v[0] = (uint64_t)c & FE_MASK51;
  r.v[1] += (uint64_t)(c >> 51);
  return r;
}

HD fe fe_mul(const fe& a, const fe& b) {
  FE_COUNT_MUL();
  return fe_product(a, b);
}

HD fe fe_sq(const fe& a) {
  FE_COUNT_SQ();
  return fe_product(a, a);
}

HD fe fe_pow2k(fe a, int k) {
  for (int i = 0; i < k; i++) a = fe_sq(a);
  return a;
}

// Shared prefix of the inversion and square-root chains: z^11 and z^(2^250-1).
HD void fe_chain(const fe& z, fe& z11, fe& z2_250_0) {
  fe z2 = fe_sq(z);
  fe z9 = fe_mul(fe_sq(fe_sq(z2)), z);
  z11 = fe_mul(z9, z2);
  fe z2_5_0 = fe_mul(fe_sq(z11), z9);
  fe z2_10_0 = fe_mul(fe_pow2k(z2_5_0, 5), z2_5_0);
  fe z2_20_0 = fe_mul(fe_pow2k(z2_10_0, 10), z2_10_0);
  fe z2_40_0 = fe_mul(fe_pow2k(z2_20_0, 20), z2_20_0);
  fe z2_50_0 = fe_mul(fe_pow2k(z2_40_0, 10), z2_10_0);
  fe z2_100_0 = fe_mul(fe_pow2k(z2_50_0, 50), z2_50_0);
  fe z2_200_0 = fe_mul(fe_pow2k(z2_100_0, 100), z2_100_0);
  z2_250_0 = fe_mul(fe_pow2k(z2_200_0, 50), z2_50_0);
}

HD fe fe_invert(const fe& z) {  // z^(p-2)
  fe z11, z2_250_0;
  fe_chain(z, z11, z2_250_0);
  return fe_mul(fe_pow2k(z2_250_0, 5), z11);
}

HD fe fe_pow22523(const fe& z) {  // z^((p-5)/8)
  fe z11, z2_250_0;
  fe_chain(z, z11, z2_250_0);
  return fe_mul(fe_pow2k(z2_250_0, 2), z);
}

// Canonical representative in [0, p), as exact 51-bit chunks of the value
// (curve25519-donna's fcontract).
HD fe fe_canonical(fe t) {
  for (int pass = 0; pass < 2; pass++) {
    t.v[1] += t.v[0] >> 51; t.v[0] &= FE_MASK51;
    t.v[2] += t.v[1] >> 51; t.v[1] &= FE_MASK51;
    t.v[3] += t.v[2] >> 51; t.v[2] &= FE_MASK51;
    t.v[4] += t.v[3] >> 51; t.v[3] &= FE_MASK51;
    t.v[0] += 19 * (t.v[4] >> 51); t.v[4] &= FE_MASK51;
  }
  // Now in [0, 2^255): add 19, carry; values >= p wrap past 2^255.
  t.v[0] += 19;
  t.v[1] += t.v[0] >> 51; t.v[0] &= FE_MASK51;
  t.v[2] += t.v[1] >> 51; t.v[1] &= FE_MASK51;
  t.v[3] += t.v[2] >> 51; t.v[2] &= FE_MASK51;
  t.v[4] += t.v[3] >> 51; t.v[3] &= FE_MASK51;
  t.v[0] += 19 * (t.v[4] >> 51); t.v[4] &= FE_MASK51;
  // Offset by 2^255 - 19 so the final carry out of limb 4 is the 2^255 bit.
  t.v[0] += 0x8000000000000ULL - 19;
  t.v[1] += 0x8000000000000ULL - 1;
  t.v[2] += 0x8000000000000ULL - 1;
  t.v[3] += 0x8000000000000ULL - 1;
  t.v[4] += 0x8000000000000ULL - 1;
  t.v[1] += t.v[0] >> 51; t.v[0] &= FE_MASK51;
  t.v[2] += t.v[1] >> 51; t.v[1] &= FE_MASK51;
  t.v[3] += t.v[2] >> 51; t.v[2] &= FE_MASK51;
  t.v[4] += t.v[3] >> 51; t.v[3] &= FE_MASK51;
  t.v[4] &= FE_MASK51;
  return t;
}

HD bool fe_eq_exact(const fe& a, const fe& b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
         a.v[3] == b.v[3] && a.v[4] == b.v[4];
}

HD bool fe_eq(const fe& a, const fe& b) {
  return fe_eq_exact(fe_canonical(a), fe_canonical(b));
}

HD bool fe_is_zero(const fe& a) { return fe_eq_exact(fe_canonical(a), fe_zero()); }

HD int fe_parity(const fe& a) { return (int)(fe_canonical(a).v[0] & 1); }

// 20 x 13-bit limbs (each < 2^13, value < 2^255) -> 5 x 51-bit limbs, exact.
// `stride` is the distance between consecutive limbs in int32 elements.
HD fe fe_from13(const int32_t* limbs, int stride) {
  fe r = fe_zero();
  for (int i = 0; i < 20; i++) {
    const uint64_t x = (uint32_t)limbs[i * stride];
    const int bit = 13 * i, q = bit / 51, s = bit % 51;
    r.v[q] |= (x << s) & FE_MASK51;
    if (s + 13 > 51 && q + 1 < 5) r.v[q + 1] |= x >> (51 - s);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Points (twisted Edwards, a = -1)

HD ge ge_identity() {
  ge p; p.X = fe_zero(); p.Y = fe_one(); p.Z = fe_one(); p.T = fe_zero(); return p;
}

HD gc ge_to_cached(const ge& p) {
  gc q;
  q.ymx = fe_sub(p.Y, p.X);
  q.ypx = fe_add(p.Y, p.X);
  q.z2 = fe_add(p.Z, p.Z);
  q.t2d = fe_mul(p.T, fe_d2());
  return q;
}

// p + q with q in cached form: unified addition add-2008-hwcd-3 (complete for
// a = -1), 8 multiplies, 7 when the caller needs no T (the next operation is
// a doubling, which never reads it; T is then left zero).
HD ge ge_add_cached(const ge& p, const gc& q, bool want_t = true) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.ymx);
  fe b = fe_mul(fe_add(p.Y, p.X), q.ypx);
  fe c = fe_mul(p.T, q.t2d);
  fe d = fe_mul(p.Z, q.z2);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r; r.X = fe_mul(e, f); r.Y = fe_mul(g, h); r.Z = fe_mul(f, g);
  r.T = want_t ? fe_mul(e, h) : fe_zero();
  return r;
}

HD ge ge_add(const ge& p, const ge& q) { return ge_add_cached(p, ge_to_cached(q)); }

// Mixed addition with a Niels-form point (madd-2008-hwcd).
HD ge ge_madd(const ge& p, const gn& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.ymx);
  fe b = fe_mul(fe_add(p.Y, p.X), q.ypx);
  fe c = fe_mul(p.T, q.t2d);
  fe d = fe_add(p.Z, p.Z);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r; r.X = fe_mul(e, f); r.Y = fe_mul(g, h); r.Z = fe_mul(f, g); r.T = fe_mul(e, h);
  return r;
}

// Doubling dbl-2008-hwcd: never reads T, and emits it only when asked (as
// ge_add_cached; the TPU kernel's point_double(want_t=...)).
HD ge ge_double(const ge& p, bool want_t = true) {
  fe a = fe_sq(p.X);
  fe b = fe_sq(p.Y);
  fe zz = fe_sq(p.Z);
  fe c = fe_add(zz, zz);
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sq(fe_add(p.X, p.Y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  ge r; r.X = fe_mul(e, f); r.Y = fe_mul(g, h); r.Z = fe_mul(f, g);
  r.T = want_t ? fe_mul(e, h) : fe_zero();
  return r;
}

// One Niels entry of a 51-bit comb: 16 uint64 (ymx[5] ypx[5] t2d[5], one pad
// limb), one 128-byte line, read on the device as eight 16-byte loads through
// the read-only path.
HD gn gn_load51(const uint64_t* entry) {
  uint64_t w[16];
#ifdef __CUDA_ARCH__
  const ulonglong2* line = reinterpret_cast<const ulonglong2*>(entry);
  for (int i = 0; i < 8; i++) {
    const ulonglong2 v = __ldg(line + i);
    w[2 * i] = v.x;
    w[2 * i + 1] = v.y;
  }
#else
  for (int i = 0; i < 16; i++) w[i] = entry[i];
#endif
  gn q;
  for (int l = 0; l < 5; l++) {
    q.ymx.v[l] = w[l];
    q.ypx.v[l] = w[5 + l];
    q.t2d.v[l] = w[10 + l];
  }
  return q;
}

// RFC 8032 decompression of (y, sign); y < 2^255 and may be >= p (the
// prologue's canonicity bit covers that).  Returns false on an invalid point.
HD bool ge_decompress(const fe& y, int sign, ge& out) {
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, fe_one());
  fe v = fe_add(fe_mul(yy, fe_d()), fe_one());
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  bool ok_direct = fe_eq(vxx, u);
  bool ok_flipped = fe_eq(vxx, fe_neg(u));
  if (!ok_direct) x = fe_mul(x, fe_sqrt_m1());
  bool ok = ok_direct || ok_flipped;
  bool x_zero = fe_is_zero(x);
  ok = ok && !(x_zero && sign == 1);
  if (fe_parity(x) != sign && !x_zero) x = fe_neg(x);
  out.X = x; out.Y = y; out.Z = fe_one(); out.T = fe_mul(x, y);
  return ok;
}

// encode(p) == R, exactly: the affine y must equal the RAW R limbs (a
// non-canonical R, y >= p, never equals a canonical value) and the parity of
// x must equal R's sign bit.
HD bool ge_matches(const ge& p, const int32_t* r_y, int r_sign) {
  fe zinv = fe_invert(p.Z);
  fe x = fe_mul(p.X, zinv);
  fe y = fe_mul(p.Y, zinv);
  return fe_eq_exact(fe_canonical(y), fe_from13(r_y, 1)) && fe_parity(x) == r_sign;
}
