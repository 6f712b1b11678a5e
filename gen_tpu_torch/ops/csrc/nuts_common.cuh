// Helpers shared by the fused NUTS kernels K3 (nuts_pair.cu) and K6
// (nuts_tick.cu): Philox4x32-10, uniforms and Box-Muller normals, the
// logaddexp formula of jnp.logaddexp, bf16x2 checkpoint packing with
// gen_tpu's integer rounding, and the mass-weighted dot products.
//
// ops/nuts_fused.py splices this file's text into each kernel's generated
// source in place of its NUTS_COMMON marker line (the source is compiled
// in the build directory, where no relative #include would be found, and
// the build cache hashes the spliced text, so an edit here rebuilds both
// kernels). The including source defines NUTS_D, NUTS_UNROLL,
// NUTS_VAG_INLINE and staged_vag first.

namespace {

constexpr float kTiny = 1.1754944e-38f;   // FLT_MIN: keeps log(u) finite

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ NUTS_VAG_INLINE void vag(const float* x, const float* r,
                                    float& lp, float* g) {
  staged_vag(x, r, lp, g);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// uint32 bits -> float uniform on [0, 1) (the mantissa construction)
__device__ __forceinline__ float u01(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float& z0, float& z1) {
  const float u1 = fmaxf(u01(b1), kTiny);
  const float u2 = u01(b2);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.2831855f * u2, &s, &c);
  z0 = r * c;
  z1 = r * s;
}

// NUTS_D standard normals from Philox counters (i, step, tag0 + c, 0),
// c = 0..ceil(NUTS_D / 4) - 1
__device__ __forceinline__ void philox_normals(float* z, uint32_t i,
                                               uint32_t step, uint32_t tag0,
                                               uint2 key) {
  NUTS_UNROLL
  for (int c = 0; c < (NUTS_D + 3) / 4; ++c) {
    const uint4 b = philox4x32_10(make_uint4(i, step, tag0 + c, 0u), key);
    float q[4];
    box_muller(b.x, b.y, q[0], q[1]);
    box_muller(b.z, b.w, q[2], q[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * c + t < NUTS_D) z[4 * c + t] = q[t];
  }
}

// jnp.logaddexp's formula, as the twin writes it out
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  return isnan(d) ? a + b : fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

// bf16 round-to-nearest-even bits (gen_tpu's integer arithmetic; the carry
// of an all-ones-mantissa NaN wraps as in the twin)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) >> 16);
}

__device__ __forceinline__ float unpack_hi(uint32_t p) {
  return __uint_as_float(p & 0xFFFF0000u);
}

__device__ __forceinline__ float unpack_lo(uint32_t p) {
  return __uint_as_float(p << 16);
}

// sum_j (inv_j a_j) b_j, j = 0..D-1 in order
__device__ __forceinline__ float dot_im(const float* inv, const float* a,
                                        const float* b) {
  float acc = (inv[0] * a[0]) * b[0];
  NUTS_UNROLL
  for (int j = 1; j < NUTS_D; ++j) acc = acc + (inv[j] * a[j]) * b[j];
  return acc;
}

__device__ __forceinline__ float kinetic(const float* inv, const float* r) {
  return 0.5f * dot_im(inv, r, r);
}

__device__ __forceinline__ bool uturn(const float* inv, const float* rho,
                                      const float* ra, const float* rb) {
  return (dot_im(inv, rho, ra) <= 0.0f) || (dot_im(inv, rho, rb) <= 0.0f);
}

// the U-turn test of a checkpoint block: rho = rs - (packed rho sum),
// against the packed momentum and rb, both sums in order 0..D-1
__device__ __forceinline__ bool uturn_block(const float* inv, const float* rs,
                                            const uint32_t* ck,
                                            const float* rb) {
  float a = 0.0f, b = 0.0f;
  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) {
    const float br = rs[k] - unpack_lo(ck[k]);
    const float ta = (inv[k] * br) * unpack_hi(ck[k]);
    const float tb = (inv[k] * br) * rb[k];
    a = k == 0 ? ta : a + ta;
    b = k == 0 ? tb : b + tb;
  }
  return a <= 0.0f || b <= 0.0f;
}

__device__ __forceinline__ void copy(float* dst, const float* src) {
  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) dst[k] = src[k];
}

}  // namespace
