// Philox4x32-10, uniforms on [0, 1) and Box-Muller normals: the random
// numbers of the fused HMC kernel K1 (hmc_fused.cu), the fused NUTS kernels
// K3 and K6 (through nuts_common.cuh) and the batched-categorical kernel K5.
//
// A source splices this file's text in place of its INCLUDE marker line
// for it (gen_tpu_torch/ops/_cuda_build.py::csrc_text), inside its
// anonymous namespace: the sources are compiled in the build directory,
// where no relative #include would be found, and the build cache hashes
// the spliced text.

constexpr float kTiny = 1.1754944e-38f;   // FLT_MIN: keeps log(u) finite

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
