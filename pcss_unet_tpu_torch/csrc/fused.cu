// The two passes that bracket every inference call (port of
// pcss_unet_tpu/ops/pallas/fused.py), redesigned for the H100.
//
// K1 scrub_standardize replaces fused.py::fused_scrub_standardize:
//   NaN -> 0, +Inf -> 1, -Inf -> 0, then (x - mean[c]) * inv_std[c] with
//   inv_std = 1/(std + 1e-8), each step one IEEE rounding (__fsub_rn,
//   __fmul_rn, __fdiv_rn, __fadd_rn), rounded once to the output type.
//   The output is not only the reference's [N,H,W,C]: K1 writes the forward's
//   first input in the layout the posture's first stage reads, in one pass.
//   Every layout is a strided view of one 6-D index (n, h', dy, w', dx, c)
//   over the source pixel x[n, h'R + dy, w'R + dx, c]:
//     entry none  R = 1, out [N, H, W, C]
//     entry nhwc  R = 2, out [N, H/2, W/2, 4C], channel c*4 + dy*2 + dx
//     entry chw   R = 2, out [N, 4C, H/2, Wp], the same channel order, with
//                 zero pad columns w' in [W/2, Wp)
//   so the kernel takes the destination's six strides.  One thread owns one
//   unit (n, h', w'): R x R source pixels, all channels.
// K4 mask_to_u8 replaces fused.py::fused_mask_to_u8:
//   NaN -> 0, clip to [0, 1], rint(x * 255) (half to even), uint8.
//
// Both are bound by memory bytes (3.35 TB/s): each input byte is read once
// and each output byte (pad columns included) written once.  At w16
// 2048x1024, K1 into the chw entry reads 33.55 MB and writes 18.87 MB
// (15.6 us); K4 reads 8.39 MB and writes 2.10 MB (3.1 us).  What the design
// does about it:
//   - K1 reads each pixel's C = 4 channels as one float4 (the channel is the
//     vector lane, so no index arithmetic per value), and computes inv_std
//     itself: the wrapper makes no launch besides the kernel's.
//   - K1 stores as wide as the destination allows: a unit's 4R^2 values are
//     contiguous in the none and nhwc layouts (8 to 64 bytes, stored as
//     uint2 / uint4); in the chw layout they fall in 4R^2 planes, and the
//     warp's 32 consecutive w' make each scalar store a whole 64-byte (bf16)
//     or 128-byte (float32) segment of a plane.
//   - K1 writes every byte of the destination, pad columns included, so the
//     wrapper allocates with torch.empty and runs no F.pad.
//   - K4: each thread quantizes 16 pixels (four float4 loads, one uint4
//     store) in a grid-stride loop over a grid sized to the SMs.
// Any C, or an input not 16-byte aligned, takes element-by-element kernels.
#include "common.cuh"

// Destination of K1: six element strides of (n, h', dy, w', dx, c).
struct ScrubArgs {
  const float* x;
  const float* mean;
  const float* std;
  void* out;
  int h, w, c, r;      // source frame [N, H, W, C]; R = 1 or 2
  int hs, ws, wout;    // H/R, W/R, and w' columns written (ws plus pad)
  long long sn, sh, sdy, sw, sdx, sc;
};

__device__ __forceinline__ float scrub(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? 1.f : 0.f;
  return v;
}

__device__ __forceinline__ float inv_std(float s) { return __fdiv_rn(1.f, __fadd_rn(s, 1e-8f)); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// v[0..NV) into contiguous OutT at dst (16-byte aligned for 16 bytes or
// more, 8-byte aligned below), as uint4 / uint2 stores.
template <typename OutT, int NV>
__device__ __forceinline__ void store_unit(OutT* dst, const float (&v)[NV]) {
  constexpr bool kBf16 = sizeof(OutT) == 2;
  constexpr int NW = kBf16 ? NV / 2 : NV;
  uint32_t wd[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wd[i] = kBf16 ? pack2(v[2 * i], v[2 * i + 1]) : __float_as_uint(v[i]);
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(wd[4 * i], wd[4 * i + 1], wd[4 * i + 2], wd[4 * i + 3]);
  } else {
    static_assert(NW == 2, "a unit is 8 bytes or a multiple of 16");
    *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
  }
}

// C = 4, x 16-byte aligned.  PLANES: the chw layout (scalar stores, zero pad
// columns); otherwise the unit's values are contiguous in the order
// c*R^2 + dy*R + dx at its base (the none and nhwc layouts).  Grid: x over
// the N*H/R rows of units, y over blocks of 128 w'.
template <typename OutT, int R, bool PLANES>
__global__ void __launch_bounds__(128) scrub_vec_kernel(const ScrubArgs a) {
  constexpr int NV = 4 * R * R;
  const int ws = blockIdx.y * blockDim.x + threadIdx.x;
  if (ws >= a.wout) return;
  const int n = blockIdx.x / a.hs, hs = blockIdx.x - n * a.hs;
  OutT* out = static_cast<OutT*>(a.out) + n * a.sn + hs * a.sh + ws * a.sw;
  if (PLANES && ws >= a.ws) {  // a pad column: zero in every plane
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i / (R * R), dy = (i / R) % R, dx = i % R;
      out[c * a.sc + dy * a.sdy + dx * a.sdx] = from_float<OutT>(0.f);
    }
    return;
  }
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float v[NV];
#pragma unroll
  for (int dy = 0; dy < R; ++dy) {
    const long long pix = ((long long)n * a.h + hs * R + dy) * a.w + ws * R;
#pragma unroll
    for (int dx = 0; dx < R; ++dx) {
      const float4 p = __ldg(x4 + pix + dx);
      v[0 * R * R + dy * R + dx] = p.x;
      v[1 * R * R + dy * R + dx] = p.y;
      v[2 * R * R + dy * R + dx] = p.z;
      v[3 * R * R + dy * R + dx] = p.w;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float m = __ldg(a.mean + c), inv = inv_std(__ldg(a.std + c));
#pragma unroll
    for (int j = 0; j < R * R; ++j)
      v[c * R * R + j] = __fmul_rn(__fsub_rn(scrub(v[c * R * R + j]), m), inv);
  }
  if constexpr (PLANES) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i / (R * R), dy = (i / R) % R, dx = i % R;
      out[c * a.sc + dy * a.sdy + dx * a.sdx] = from_float<OutT>(v[i]);
    }
  } else {
    store_unit<OutT, NV>(out, v);
  }
}

// Any C, any alignment: one value at a time, the same grid.
template <typename OutT>
__global__ void __launch_bounds__(128) scrub_general_kernel(const ScrubArgs a) {
  const int ws = blockIdx.y * blockDim.x + threadIdx.x;
  if (ws >= a.wout) return;
  const int n = blockIdx.x / a.hs, hs = blockIdx.x - n * a.hs;
  OutT* out = static_cast<OutT*>(a.out) + n * a.sn + hs * a.sh + ws * a.sw;
  const bool pad = ws >= a.ws;
  for (int c = 0; c < a.c; ++c) {
    const float m = a.mean[c], inv = inv_std(a.std[c]);
    for (int dy = 0; dy < a.r; ++dy)
      for (int dx = 0; dx < a.r; ++dx) {
        float y = 0.f;
        if (!pad) {
          const long long pix = ((long long)n * a.h + hs * a.r + dy) * a.w + ws * a.r + dx;
          y = __fmul_rn(__fsub_rn(scrub(a.x[pix * a.c + c]), m), inv);
        }
        out[c * a.sc + dy * a.sdy + dx * a.sdx] = from_float<OutT>(y);
      }
  }
}

__device__ __forceinline__ uint32_t mask_u8_one(float v) {
  // NaN first: fminf/fmaxf return the non-NaN operand, so clipping first
  // would send NaN to 0 or 255 by accident of operand order.
  if (isnan(v)) return 0u;
  v = fminf(fmaxf(v, 0.f), 1.f);
  return (uint32_t)rintf(__fmul_rn(v, 255.f));
}

__device__ __forceinline__ uint32_t mask_u8_word(const float4 v) {
  return mask_u8_one(v.x) | (mask_u8_one(v.y) << 8) | (mask_u8_one(v.z) << 16) |
         (mask_u8_one(v.w) << 24);
}

// VEC (x 16-byte aligned): 16 values a thread, then the < 16 left one by
// one; otherwise every value one by one.
template <bool VEC>
__global__ void __launch_bounds__(256) mask_to_u8_kernel(const float* __restrict__ x,
                                                         unsigned char* __restrict__ out,
                                                         long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n16 = n / 16;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint4* o16 = reinterpret_cast<uint4*>(out);
    for (long long j = tid; j < n16; j += stride) {
      const float4 a = __ldg(x4 + 4 * j), b = __ldg(x4 + 4 * j + 1);
      const float4 c = __ldg(x4 + 4 * j + 2), d = __ldg(x4 + 4 * j + 3);
      o16[j] = make_uint4(mask_u8_word(a), mask_u8_word(b), mask_u8_word(c), mask_u8_word(d));
    }
    done = 16 * n16;
  }
  for (long long i = done + tid; i < n; i += stride) out[i] = (unsigned char)mask_u8_one(x[i]);
}

static int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev] &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return cached[dev];
}

template <typename OutT>
static void launch_scrub(const ScrubArgs& a, int n_rows, int mode, cudaStream_t s) {
  const dim3 grid(n_rows, (a.wout + 127) / 128);
  if (mode == 0) {
    scrub_general_kernel<OutT><<<grid, 128, 0, s>>>(a);
  } else if (mode == 1 && a.r == 1) {
    scrub_vec_kernel<OutT, 1, false><<<grid, 128, 0, s>>>(a);
  } else if (mode == 1) {
    scrub_vec_kernel<OutT, 2, false><<<grid, 128, 0, s>>>(a);
  } else {
    scrub_vec_kernel<OutT, 2, true><<<grid, 128, 0, s>>>(a);
  }
}

extern "C" {

const char* pcss_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [N, H, W, C] float32 contiguous; mean, std [C] float32; out as the six
// strides say.  mode 0: element by element (any C, any alignment); 1: C = 4,
// x and out 16-byte aligned, each unit's values contiguous (none, nhwc);
// 2: C = 4, x 16-byte aligned, R = 2, the chw planes.
int pcss_scrub_standardize(const void* x, const void* mean, const void* std, void* out,
                           int n, int h, int w, int c, int r, int wout, long long sn,
                           long long sh, long long sdy, long long sw, long long sdx,
                           long long sc, int out_bf16, int mode, void* stream) {
  if (r < 1 || r > 2 || h % r || w % r || wout < w / r || mode < 0 || mode > 2 ||
      (mode != 0 && c != 4) || (mode == 2 && r != 2) || n < 1 || (long long)n * (h / r) > INT32_MAX ||
      (wout + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  const ScrubArgs a{(const float*)x, (const float*)mean, (const float*)std, out, h, w, c, r,
                    h / r, w / r, wout, sn, sh, sdy, sw, sdx, sc};
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    launch_scrub<__nv_bfloat16>(a, n * (h / r), mode, s);
  } else {
    launch_scrub<float>(a, n * (h / r), mode, s);
  }
  PCSS_CHECK_LAUNCH();
  return 0;
}

// vec: x 16-byte aligned (out from torch.empty always is).
int pcss_mask_to_u8(const void* x, void* out, long long n, int vec, void* stream) {
  const long long units = vec ? n / 16 + n % 16 : n;
  const long long want = (units + 255) / 256;
  const long long cap = 8LL * sm_count();  // 8 blocks of 256 fill an SM's 2048 threads
  const int grid = (int)(want < 1 ? 1 : (want > cap ? cap : want));
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    mask_to_u8_kernel<true><<<grid, 256, 0, s>>>((const float*)x, (unsigned char*)out, n);
  } else {
    mask_to_u8_kernel<false><<<grid, 256, 0, s>>>((const float*)x, (unsigned char*)out, n);
  }
  PCSS_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
