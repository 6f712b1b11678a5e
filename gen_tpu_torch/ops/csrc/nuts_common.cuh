// Helpers shared by the fused NUTS kernels K3 (nuts_pair.cu) and K6
// (nuts_tick.cu): Philox4x32-10, uniforms and Box-Muller normals (spliced
// from philox.cuh, which the fused HMC kernel K1 splices too), the
// logaddexp formula of jnp.logaddexp, bf16x2 checkpoint packing with
// gen_tpu's integer rounding, and the mass-weighted dot products. The
// batched-categorical kernel K5 (categorical.cu) takes the Philox and
// uniform helpers from here too.
//
// ops/nuts_fused.py and ops/categorical.py splice this file's text into
// each kernel's generated source in place of its NUTS_COMMON marker line
// (the source is compiled in the build directory, where no relative
// #include would be found, and the build cache hashes the spliced text, so
// an edit here rebuilds every kernel that splices it). The NUTS kernels
// define NUTS_D, NUTS_UNROLL, NUTS_VAG_INLINE and staged_vag first; the
// helpers that need them exist only where NUTS_D is defined.
//
// The NUTS kernels have two layouts, and ops/nuts_fused.py keeps the lines
// of one: those between a "LAYOUT thread" marker line and the next "LAYOUT
// end" (one thread per chain: d <= 32, or a streamed likelihood) or those
// between "LAYOUT warp" and "LAYOUT end" (one warp per chain, 32 < d <=
// 128: lane l owns coordinates 4l .. 4l+3, in registers, and every sum over
// coordinates is the lanes' partial sums, each in coordinate order, then a
// fixed butterfly of shuffles). K5 splices the whole file; neither layout's
// helpers exist there (it defines neither NUTS_D nor NUTS_CPL).

namespace {

// @@INCLUDE philox.cuh@@

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// @@LAYOUT thread stream@@
#ifdef NUTS_D
__device__ NUTS_VAG_INLINE void vag(const float* x, const float* r,
                                    float& lp, float* g,
                                    const float* __restrict__ sd, int n_pts) {
  staged_vag(x, r, lp, g, sd, n_pts);
}
#endif
// @@LAYOUT end@@

// @@LAYOUT thread stream@@
#ifdef NUTS_D
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

#endif  // NUTS_D
// @@LAYOUT end@@

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

// @@LAYOUT thread stream@@
#ifdef NUTS_D
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
#endif  // NUTS_D
// @@LAYOUT end@@

// @@LAYOUT warp@@
#ifdef NUTS_CPL
static_assert(NUTS_CPL == 4, "a lane's momentum normals are one Philox block");

__device__ __forceinline__ void vag(const float* xv, const float* r,
                                    float& lp, float* gv, int lane) {
  staged_vag_warp(xv, r, lp, gv, lane);
}

// does the lane own slot c (coordinate NUTS_CPL lane + c < NUTS_D)?
__device__ __forceinline__ bool owns(int lane, int c) {
  return NUTS_CPL * lane + c < NUTS_D;
}

// the lane's four standard normals, coordinates 4 lane .. 4 lane + 3: the
// Philox block (i, step, tag0 + lane, 0), as the one-thread layout's
// philox_normals draws it for those coordinates
__device__ __forceinline__ void lane_normals(float* z, uint32_t i,
                                             uint32_t step, uint32_t tag0,
                                             uint2 key, int lane) {
  const uint4 b = philox4x32_10(make_uint4(i, step, tag0 + lane, 0u), key);
  box_muller(b.x, b.y, z[0], z[1]);
  box_muller(b.z, b.w, z[2], z[3]);
}

// the butterfly: every lane ends with the same bits (IEEE addition commutes)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum_j (inv_j a_j) b_j: each lane over its coordinates in order (0.0 on a
// lane with none), then the butterfly
__device__ __forceinline__ float dot_im(const float* inv, const float* a,
                                        const float* b, int lane) {
  float acc = 0.0f;
  if (owns(lane, 0)) {
    acc = (inv[0] * a[0]) * b[0];
#pragma unroll
    for (int c = 1; c < NUTS_CPL; ++c)
      if (owns(lane, c)) acc = acc + (inv[c] * a[c]) * b[c];
  }
  return warp_sum(acc);
}

__device__ __forceinline__ float kinetic(const float* inv, const float* r,
                                         int lane) {
  return 0.5f * dot_im(inv, r, r, lane);
}

__device__ __forceinline__ bool uturn(const float* inv, const float* rho,
                                      const float* ra, const float* rb,
                                      int lane) {
  // every lane holds the same sums, so the short cut is warp-uniform
  return (dot_im(inv, rho, ra, lane) <= 0.0f)
      || (dot_im(inv, rho, rb, lane) <= 0.0f);
}

// the U-turn test of a checkpoint block (see the one-thread version)
__device__ __forceinline__ bool uturn_block(const float* inv, const float* rs,
                                            const uint32_t* ck,
                                            const float* rb, int lane) {
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int c = 0; c < NUTS_CPL; ++c) {
    if (!owns(lane, c)) continue;
    const float br = rs[c] - unpack_lo(ck[c]);
    const float ta = (inv[c] * br) * unpack_hi(ck[c]);
    const float tb = (inv[c] * br) * rb[c];
    a = c == 0 ? ta : a + ta;
    b = c == 0 ? tb : b + tb;
  }
  a = warp_sum(a);
  b = warp_sum(b);
  return a <= 0.0f || b <= 0.0f;
}

__device__ __forceinline__ void copy(float* dst, const float* src) {
#pragma unroll
  for (int c = 0; c < NUTS_CPL; ++c) dst[c] = src[c];
}
#endif  // NUTS_CPL
// @@LAYOUT end@@

}  // namespace
