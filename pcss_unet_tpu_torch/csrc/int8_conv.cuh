// The int8 3x3 stage shared by the int8 kernels: K3 (block_int8.cu,
// fused_block_int8_nhwc), K5 (block_int8.cu, fused_block_int8_kchunked) and
// K7 (conv3x3_int8.cu, conv3x3_int8_nhwc).
//
// Every one of them quantizes an NHWC input per row band of k_rows rows with
//   a = max|x over the band and one halo row above and below| / 127 + 1e-12
// (halo rows outside the frame count as zero), over all channels (K3, K7) or
// separately for each contraction chunk of cc channels (K5).  Blocks run in
// no order, so a band-wide max cannot be taken inside one block: it comes
// from a separate launch of per-row, per-chunk maxima (rowmax_kernel) on the
// same stream, and each block takes the max of k_rows + 2 of them.
//
// conv3x3_int8_kernel then, for one output row of PX pixels and a tile of
// output channels, stages the three input rows quantized with their chunk's
// scale in shared memory, runs the nine int8 taps (taps.cuh) chunk by chunk
// in order, and sums the chunks in float32:
//   f = sum_j (f32(int32 tap sum of chunk j) * (a_j * s[m]))   (j = 0, 1, ...)
//   v = f + b[m], LeakyReLU if asked, stored as OT
// With one chunk this is exactly K3's and K7's f32(acc) * (a * s) + b.  When
// given a bandmax buffer it also takes the band's max |stored value| with an
// atomicMax on the float bits (non-negative floats order like their bits):
// the second scale of the whole-block kernels.
#pragma once

#include "common.cuh"
#include "taps.cuh"

namespace {

constexpr int PX = 32;  // output pixels (columns of one row) per block

// grid (n*h, c/cc): rowmax[(n*h + row) * nchunks + j] = max |x| over the row's
// w pixels and chunk j's cc channels.  Block (row, 0) of a band's first row
// also zeroes that band's bandmax entry, if bandmax is given.
template <typename T>
__global__ void rowmax_kernel(const T* __restrict__ x, float* __restrict__ rowmax,
                              unsigned int* __restrict__ bandmax, int w, int c, int cc, int h,
                              int k_rows) {
  const int j = blockIdx.y, nchunks = gridDim.y;
  const T* xr = x + (size_t)blockIdx.x * w * c + (size_t)j * cc;
  float m = 0.f;
  for (int i = threadIdx.x; i < w * cc; i += blockDim.x)
    m = fmaxf(m, fabsf(to_float(xr[(size_t)(i / cc) * c + i % cc])));
  m = block_max(m);
  if (threadIdx.x == 0) {
    rowmax[(size_t)blockIdx.x * nchunks + j] = m;
    const int row = blockIdx.x % h;
    if (bandmax != nullptr && j == 0 && row % k_rows == 0)
      bandmax[(blockIdx.x / h) * (h / k_rows) + row / k_rows] = 0u;
  }
}

// The band's activation scale for chunk j: rows band*k_rows - 1 ..
// band*k_rows + k_rows, clipped to the frame.
__device__ __forceinline__ float band_scale(const float* __restrict__ rowmax, int n, int h,
                                            int band, int k_rows, int nchunks, int j) {
  float amax = 0.f;
  const int r_lo = max(band * k_rows - 1, 0), r_hi = min(band * k_rows + k_rows, h - 1);
  for (int r = r_lo; r <= r_hi; ++r) amax = fmaxf(amax, rowmax[((size_t)n * h + r) * nchunks + j]);
  return __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
}

// grid ((w + PX - 1) / PX, h, n * (co / m_tile)); dynamic shared memory
// 3 * (PX + 2) * c bytes of int8 tile + nchunks floats of scales.
//   x    [n, h, w, c]            wp  int8 [9][c/16][co][16] (16 input channels per word)
//   s, b [co] float32            out [n, h, w, co] OT
template <typename T, typename OT>
__global__ void conv3x3_int8_kernel(const T* __restrict__ x, const int4* __restrict__ wp,
                                    const float* __restrict__ s, const float* __restrict__ b,
                                    const float* __restrict__ rowmax,
                                    unsigned int* __restrict__ bandmax, OT* __restrict__ out,
                                    int h, int w, int c, int cc, int co, int m_tile, int k_rows,
                                    float slope, int apply_leaky) {
  extern __shared__ int4 smem4[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem4);  // [3][PX + 2][c]
  const int tile = 3 * (PX + 2) * c;
  float* a_s = reinterpret_cast<float*>(xq + tile);  // [nchunks]
  const int nchunks = c / cc, ntiles = co / m_tile;
  const int col0 = blockIdx.x * PX, row = blockIdx.y;
  const int n = blockIdx.z / ntiles, m0 = (blockIdx.z % ntiles) * m_tile;
  const int band = row / k_rows, nbands = h / k_rows;

  for (int j = threadIdx.x; j < nchunks; j += blockDim.x)
    a_s[j] = band_scale(rowmax, n, h, band, k_rows, nchunks, j);
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int ch = i % c, col = (i / c) % (PX + 2), r = i / (c * (PX + 2));
    const int gr = row + r - 1, gc = col0 + col - 1;
    float v = 0.f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      v = to_float(x[(((size_t)n * h + gr) * w + gc) * c + ch]);
    xq[i] = quant_i8(v, a_s[ch / cc]);
  }
  __syncthreads();

  const int cw16 = c / 16, chunk16 = cc / 16;
  float omax = 0.f;
  for (int m = m0 + threadIdx.x; m < m0 + m_tile; m += blockDim.x) {
    float f[PX];
#pragma unroll 1
    for (int j = 0; j < nchunks; ++j) {
      int acc[PX];
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[p] = 0;
      conv3x3_band_taps_i8<PX>(smem4, cw16, j * chunk16, (j + 1) * chunk16, wp + m, co, acc);
      const float scale = __fmul_rn(a_s[j], s[m]);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const float part = __fmul_rn(__int2float_rn(acc[p]), scale);
        f[p] = j == 0 ? part : __fadd_rn(f[p], part);
      }
    }
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int col = col0 + p;
      if (col < w) {
        float v = __fadd_rn(f[p], b[m]);
        if (apply_leaky) v = leaky(v, slope);
        const OT o = from_float<OT>(v);
        out[(((size_t)n * h + row) * w + col) * co + m] = o;
        omax = fmaxf(omax, fabsf(to_float(o)));
      }
    }
  }
  if (bandmax != nullptr) {  // uniform over the block
    omax = block_max(omax);
    if (threadIdx.x == 0) atomicMax(&bandmax[n * nbands + band], __float_as_uint(omax));
  }
}

inline int threads_for(int channels) {
  const int t = ((channels + 31) / 32) * 32;
  return t > 256 ? 256 : t;
}

// rowmax_kernel then conv3x3_int8_kernel on one stream.
template <typename T, typename OT>
int launch_conv3x3_int8(const void* x, const void* wp, const void* s, const void* b,
                        void* rowmax, void* bandmax, void* out, int n, int h, int w, int c, int cc,
                        int co, int m_tile, int k_rows, float slope, int apply_leaky,
                        cudaStream_t stream) {
  const int nchunks = c / cc;
  rowmax_kernel<T><<<dim3(n * h, nchunks), 256, 0, stream>>>(
      (const T*)x, (float*)rowmax, (unsigned int*)bandmax, w, c, cc, h, k_rows);
  PCSS_CHECK_LAUNCH();
  const size_t smem = (size_t)3 * (PX + 2) * c + sizeof(float) * nchunks;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_int8_kernel<T, OT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w + PX - 1) / PX, h, n * (co / m_tile));
  conv3x3_int8_kernel<T, OT><<<grid, threads_for(m_tile), smem, stream>>>(
      (const T*)x, (const int4*)wp, (const float*)s, (const float*)b, (const float*)rowmax,
      (unsigned int*)bandmax, (OT*)out, h, w, c, cc, co, m_tile, k_rows, slope, apply_leaky);
  PCSS_CHECK_LAUNCH();
  return 0;
}

}  // namespace
