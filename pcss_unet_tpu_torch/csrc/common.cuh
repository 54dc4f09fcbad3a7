// Shared helpers of the port's CUDA kernels (built for sm_90a by
// pcss_unet_tpu_torch/ops/kernels/_build.py).
//
// Every kernel computes in float32 from bf16 or float32 storage.  Rounding is
// spelled out with __fmul_rn / __fadd_rn / __fdiv_rn where the reference does
// a separate multiply and add, so that nvcc cannot contract them into one FMA
// and the int8 quantization ties land where the plain PyTorch version puts
// them.  The build does not pass --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// LeakyReLU as the reference writes it: where(v >= 0, v, v * slope).
__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : __fmul_rn(v, slope);
}

// Symmetric int8 quantization q(v) = clip(rint(v / a), -127, 127) with true
// division and round half to even (jnp.round / torch.round), bit for bit,
// without a division per value, for the int8 kernels' activations.  Given
// y = RN(1/a)
// (__frcp_rn) and a24 = a * 2^-24, q = v * y is within two ulp of z = v / a;
// with |v| <= 127 a (the band scales guarantee it) that is |z - q| <= 2^-16,
// so a q farther than 2^-14 from every half-integer rounds as z does:
// rint(clamp(q)), which x + 1.5 * 2^23 computes (half to even, the integer in
// the low mantissa bits).  Near a half-integer quant_i8_near decides exactly:
// z's nearest integer is rint(q) or its neighbour across h, the half-integer
// on q's side; the sign of z - h is the sign of fma(-h, a, v) (one rounding
// of v - h*a), and RN(z) == h, a tie that rint sends to even, iff
// |v - h*a| <= a * ulp(h) / 2, which the rounded fma decides exactly because
// a quotient of two floats is never a midpoint between floats and so stays
// more than a * ulp(h) * 2^-25 away from that threshold.  (Below h = +-0.5
// the threshold is one float too wide; both answers are 0 there.)
constexpr float kRoundMagic = 12582912.f;  // 1.5 * 2^23

__device__ __forceinline__ float quant_i8_near(float v, float a, float y, float a24) {
  const float q = __fmul_rn(v, y), k0 = rintf(q);
  const float h = __fadd_rn(k0, copysignf(0.5f, __fsub_rn(q, k0)));
  const float d = __fmaf_rn(-h, a, v);
  const float p = __uint_as_float(__float_as_uint(h) & 0x7f800000u);  // 2^floor(log2 |h|)
  const float k = fabsf(d) <= __fmul_rn(a24, p) ? rintf(h)
                  : d > 0.f                     ? __fadd_rn(h, 0.5f)
                                                : __fsub_rn(h, 0.5f);
  return fminf(fmaxf(k, -127.f), 127.f);
}

// q(v[i]) for 16 values, packed as int8 into 16 bytes (v[0] in the low byte
// of .x)
__device__ __forceinline__ uint4 quant16_i8(const float (&v)[16], float a, float y, float a24) {
  uint32_t m[16];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float qc = fminf(fmaxf(__fmul_rn(v[i], y), -127.f), 127.f);
    const float r = __fadd_rn(qc, kRoundMagic);
    near |= fabsf(__fsub_rn(fabsf(__fsub_rn(qc, __fsub_rn(r, kRoundMagic))), 0.5f)) < 0x1p-14f;
    m[i] = __float_as_uint(r);
  }
  if (near) {  // rare: some value within 2^-14 of a tie
#pragma unroll
    for (int i = 0; i < 16; ++i)
      m[i] = __float_as_uint(__fadd_rn(quant_i8_near(v[i], a, y, a24), kRoundMagic));
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = __byte_perm(__byte_perm(m[4 * i], m[4 * i + 1], 0x0040),
                       __byte_perm(m[4 * i + 2], m[4 * i + 3], 0x0040), 0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// max over the block; every thread gets the result.  blockDim.x % 32 == 0.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // warp_max may still be read by a previous call
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) v = fmaxf(v, warp_max[i]);
  return v;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (bit d of `done`) instead of on every launch.
inline int allow_smem(const void* kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done |= bit;
  return 0;
}

// Launch check shared by the C entry points: a refused launch never runs and
// is only visible through cudaGetLastError.
#define PCSS_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)
