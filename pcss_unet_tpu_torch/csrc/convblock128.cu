// K6: whole folded ConvBlock on NHWC for the 128-channel stages (replaces
// pcss_unet_tpu/ops/pallas/convblock128.py::fused_block128_nhwc, body _kernel).
//
//   out = leaky(cast(leaky(conv3x3_SAME(x, W1) + b1)) · W2 + b2), cast to x's dtype
//
// x [N, H, W, C] bf16 or float32 with C % 128 == 0, Cin == Cmid, Cout <= Cmid.
// Rows and columns outside the frame read as zero (SAME padding).  Products
// of the storage dtype's values sum in float32; the hidden value is rounded
// to the storage dtype before the 1x1, as the reference does on the TPU.
//
// What bounds it on the H100: at w64 dec_2 (x [1,272,480,128], Cout 64) the
// block does 20.3 G multiply-adds, 0.041 ms at the 989 TFLOP/s bf16
// tensor-core rate, and moves ~50 MB (~0.015 ms): operations.  This first
// kernel runs them on the float32 CUDA cores (67 TFLOP/s), not the tensor
// cores.  Design (the channels-major K2 kernel's, on NHWC): one block per
// (n, row, 128-column tile); the input rows r-1..r+1 are staged in shared
// memory 16 channels at a time; each warp owns 4-wide groups of 128 hidden
// channels for 64 of the 128 pixels (2 per lane), keeps their float32 sums in
// registers and reads each weight float4 once per (tap, input channel) as a
// warp-uniform broadcast.  Hidden channels go 128 at a time into a rounded
// [Cmid][128] tile in shared memory that feeds the 1x1 the same way.
#include "common.cuh"

namespace {

constexpr int TW = 128;   // output columns per block
constexpr int XW = TW + 2;
constexpr int CC = 16;    // input channels staged per step
constexpr int NT = 256;   // threads per block: 8 warps
constexpr int SLOTS = 8;  // 4-channel groups per warp: 8 slots * 4 warps-per-half * 4 = 128

template <typename T>
__global__ void __launch_bounds__(NT)
block128_kernel(const T* __restrict__ x, const float* __restrict__ w1t,
                const float* __restrict__ b1, const float* __restrict__ w2t,
                const float* __restrict__ b2, T* __restrict__ out, int c, int cout, int h, int w,
                float slope) {
  extern __shared__ float smem[];
  float* xs = smem;                // [CC][3][XW]
  float* hs = smem + CC * 3 * XW;  // [c][TW]
  const int col0 = blockIdx.x * TW, row = blockIdx.y, n = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w works on pixels half*64 + lane + 32*j (j = 0, 1) and on channel
  // groups g = (w >> 1) + 4*s for slots s = 0..SLOTS-1 of each 128 block
  const int half = warp & 1, gbase = warp >> 1;
  const int p0 = half * 64 + lane;
  float acc[SLOTS][4][2];

  // ---- 3x3 conv, 128 hidden channels at a time, into the hidden tile ----
  for (int mb = 0; mb < c; mb += 128) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s][k][0] = acc[s][k][1] = 0.f;
    for (int c0 = 0; c0 < c; c0 += CC) {
      __syncthreads();
      for (int i = threadIdx.x; i < CC * 3 * XW; i += NT) {
        const int ci = i % CC, col = (i / CC) % XW, r = i / (CC * XW);
        const int gr = row + r - 1, gc = col0 + col - 1;
        float v = 0.f;
        if (gr >= 0 && gr < h && gc >= 0 && gc < w)
          v = to_float(x[(((size_t)n * h + gr) * w + gc) * c + c0 + ci]);
        xs[(ci * 3 + r) * XW + col] = v;
      }
      __syncthreads();
      for (int ci = 0; ci < CC; ++ci) {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int dy = t / 3, dx = t % 3;  // tap dy*3 + dx, as w1 [9, C, Cmid]
          const float* xr = xs + (ci * 3 + dy) * XW + dx;
          const float xv0 = xr[p0], xv1 = xr[p0 + 32];
          const float* wrow = w1t + ((size_t)t * c + c0 + ci) * c + mb;
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(wrow) + gbase + 4 * s);
            acc[s][0][0] = fmaf(wv.x, xv0, acc[s][0][0]);
            acc[s][0][1] = fmaf(wv.x, xv1, acc[s][0][1]);
            acc[s][1][0] = fmaf(wv.y, xv0, acc[s][1][0]);
            acc[s][1][1] = fmaf(wv.y, xv1, acc[s][1][1]);
            acc[s][2][0] = fmaf(wv.z, xv0, acc[s][2][0]);
            acc[s][2][1] = fmaf(wv.z, xv1, acc[s][2][1]);
            acc[s][3][0] = fmaf(wv.w, xv0, acc[s][3][0]);
            acc[s][3][1] = fmaf(wv.w, xv1, acc[s][3][1]);
          }
        }
      }
    }
    // bias, leaky, round to the storage dtype
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = mb + 4 * (gbase + 4 * s) + k;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = leaky(__fadd_rn(acc[s][k][j], b1[m]), slope);
          hs[m * TW + p0 + 32 * j] = to_float(from_float<T>(v));
        }
      }
  }
  __syncthreads();

  // ---- 1x1 conv from the hidden tile, 128 output channels at a time ----
  for (int ob = 0; ob < cout; ob += 128) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s][k][0] = acc[s][k][1] = 0.f;
    for (int m = 0; m < c; ++m) {
      const float hv0 = hs[m * TW + p0], hv1 = hs[m * TW + p0 + 32];
      const float* wrow = w2t + (size_t)m * cout + ob;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int o = ob + 4 * (gbase + 4 * s);
        if (o < cout) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(wrow) + gbase + 4 * s);
          acc[s][0][0] = fmaf(wv.x, hv0, acc[s][0][0]);
          acc[s][0][1] = fmaf(wv.x, hv1, acc[s][0][1]);
          acc[s][1][0] = fmaf(wv.y, hv0, acc[s][1][0]);
          acc[s][1][1] = fmaf(wv.y, hv1, acc[s][1][1]);
          acc[s][2][0] = fmaf(wv.z, hv0, acc[s][2][0]);
          acc[s][2][1] = fmaf(wv.z, hv1, acc[s][2][1]);
          acc[s][3][0] = fmaf(wv.w, hv0, acc[s][3][0]);
          acc[s][3][1] = fmaf(wv.w, hv1, acc[s][3][1]);
        }
      }
    }
    // bias, leaky, store
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int o0 = ob + 4 * (gbase + 4 * s);
      if (o0 < cout) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + p0 + 32 * j;
          if (col < w) {
            T* dst = out + (((size_t)n * h + row) * w + col) * cout + o0;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              dst[k] = from_float<T>(leaky(__fadd_rn(acc[s][k][j], b2[o0 + k]), slope));
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
           void* out, int n, int c, int cout, int h, int w, float slope, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)CC * 3 * XW + (size_t)c * TW);
  cudaError_t e = cudaFuncSetAttribute(block128_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w + TW - 1) / TW, h, n);
  block128_kernel<T><<<grid, NT, smem, stream>>>((const T*)x, (const float*)w1t,
                                                 (const float*)b1, (const float*)w2t,
                                                 (const float*)b2, (T*)out, c, cout, h, w, slope);
  PCSS_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// w1t [9][C][C] float32 (tap dy*3+dx, input channel, hidden channel),
// w2t [C][Cout] float32, b1 [C] / b2 [Cout] float32.
int pcss_block128_nhwc(const void* x, const void* w1t, const void* b1, const void* w2t,
                       const void* b2, void* out, int n, int c, int cout, int h, int w,
                       float slope, int is_bf16, void* stream) {
  if (c % 128 || cout % 4 || cout > c) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w1t, b1, w2t, b2, out, n, c, cout, h, w, slope, s);
  return launch<float>(x, w1t, b1, w2t, b2, out, n, c, cout, h, w, slope, s);
}

}  // extern "C"
