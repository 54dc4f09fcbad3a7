// The train-mode tail of every ConvBlock convolution on the bf16 training
// path, BatchNorm on the batch's statistics -> LeakyReLU (or ReLU) -> bf16
// -> Dropout2d, forward and backward (ops/kernels/bn_train.py::
// bn_act_dropout_train, from models/unet.py::ConvBlock.forward_train).
//
// It replaces no TPU kernel: the JAX package's training reaches no Pallas
// kernel, and XLA fuses this chain there.  It was added because the port's
// plain chain (models/unet.py::batch_norm_train, the activation, the cast,
// torch.where) runs as ~20 PyTorch launches a conv output, each a full
// float32 pass (~60 bytes an element), and autograd keeps three float32
// copies of every element for its backward: about half of a w64 training
// step's time and most of its memory.  The data-parallel and row-sharded
// paths keep the plain chain: their statistics, and the backward's sums, are
// all-reduced over the process group.
//
// Arithmetic, each step one IEEE rounding as the plain chain's separate ops
// (__fmul_rn / __fadd_rn / __fsub_rn: nvcc contracts nothing):
//   mean = E[x], ex2 = E[x^2] over (N, H, W): float32 sums of each block's
//     values, the blocks' sums added in float64 (one order: deterministic);
//   raw = ex2 - mean*mean, var = raw < 0 ? 0 : raw, rstd = 1/sqrt(var + eps)
//     (correctly rounded), mul = rstd * gamma;
//   y = (x - mean) * mul + beta; a = bf16(act(y)), act(y) = y > 0 ? y : y*slope
//     (slope 0: ReLU); with a mask, out = kept ? bf16(a * inv_keep) : 0,
//     inv_keep = RN(1 / keep) (PyTorch's CUDA division by a scalar multiplies
//     by its reciprocal);
//   running = momentum * r + (1 - momentum) * s for s = mean, var.
// Backward, the plain chain's autograd rearranged:
//   g_a = kept ? bf16(g * inv_keep) : 0 (g itself without a mask),
//   g_y = y > 0 ? g_a : g_a * slope, with y recomputed as the forward had it;
//   dbeta = sum g_y, dgamma = rstd * sum g_y (x - mean);
//   dx = bf16(mul * g_y - A - B (x - mean)), A = mul * mean(g_y),
//   B = mul * rstd^2 * mean(g_y (x - mean)), and B = 0 where raw < 0 (the
//   clamp passes no gradient to the variance there, as in autograd).
//
// Bound by bytes (3.35 TB/s).  The forward reads x twice and writes the bf16
// output (6 bytes an element), the backward reads x and g twice and writes dx
// (10 bytes): against the plain chain's ~60, with nothing float32 of
// activation size saved (x, bf16, and per-channel float32 vectors).  Three
// launches a pass: a walk that reduces (per-block partial sums, [C, parts]),
// a per-channel combine (one block a channel), and a walk that writes.  The
// walks take both storages a convolution hands over, chosen by the wrapper
// from the strides:
//   - planar (NCHW contiguous): a block walks `span` values of one channel
//     (blockIdx.y), 16 bytes (8 bf16) a thread where H*W is a multiple of 8;
//   - rows (channels-last): a row of C values a pixel; each thread owns 8
//     channels (16 bytes) of every rb-th row of the block's `span` rows, its
//     per-channel constants in registers, and a block reduces over its
//     threads' rows in shared memory.
// Either falls back to one value a thread where C (rows) or H*W (planar) is
// not a multiple of 8 or a pointer is not 16-byte aligned.  The kernels
// allocate nothing and run on the caller's stream.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 8;

enum Pass { kStats = 0, kApply = 1, kGradStats = 2, kGrad = 3 };

struct TailArgs {
  const __nv_bfloat16* x;     // the conv output
  const __nv_bfloat16* g;     // backward: the incoming gradient, x's storage
  __nv_bfloat16* out;         // the block's activation, or dx
  const unsigned char* mask;  // [n, c] keep flags; null: no dropout
  const float* weight;        // gamma [c]
  const float* bias;          // beta [c]
  const float* run_mean;      // [c]
  const float* run_var;       // [c]
  float* stats;               // [6, c]: mean, mul, rstd, live, running mean, var
  float* grads;               // [4, c]: dgamma, dbeta, A, B
  float2* part;               // [c, parts]: a block's two sums
  int n, c, hw;
  int span;                   // planar: values of a channel a block walks; rows: rows
  int parts;                  // blocks along the walk
  float eps, momentum, rest, inv_keep, slope;
};

struct Chan {  // one channel's constants in a pass
  float mean, mul, beta, a, b;
};

template <int PASS>
__device__ __forceinline__ Chan chan(const TailArgs& p, int c) {
  Chan k{0.f, 0.f, 0.f, 0.f, 0.f};
  if (PASS != kStats) {
    k.mean = p.stats[c];
    k.mul = p.stats[p.c + c];
    k.beta = p.bias[c];
  }
  if (PASS == kGrad) {
    k.a = p.grads[2 * p.c + c];
    k.b = p.grads[3 * p.c + c];
  }
  return k;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One value through the pass: the reducing passes add to s1, s2; the writing
// passes return the value to store (rounded to bf16 at the store).  kept: -1
// without a mask, else the channel's keep flag in this sample.
template <int PASS>
__device__ __forceinline__ float visit(float x, float g, const Chan& k, int kept,
                                      const TailArgs& p, float& s1, float& s2) {
  if (PASS == kStats) {
    s1 += x;
    s2 += x * x;  // exact: x is a bf16 value
    return 0.f;
  }
  const float xc = __fsub_rn(x, k.mean);
  const float y = __fadd_rn(__fmul_rn(xc, k.mul), k.beta);
  if (PASS == kApply) {
    const float a = round_bf16(y > 0.f ? y : p.slope == 0.f ? 0.f : __fmul_rn(y, p.slope));
    return kept < 0 ? a : kept ? __fmul_rn(a, p.inv_keep) : 0.f;
  }
  const float ga = kept < 0 ? g : kept ? round_bf16(__fmul_rn(g, p.inv_keep)) : 0.f;
  const float gy = y > 0.f ? ga : p.slope == 0.f ? 0.f : __fmul_rn(ga, p.slope);
  if (PASS == kGradStats) {
    s1 += gy;
    s2 += gy * xc;
    return 0.f;
  }
  return __fsub_rn(__fsub_rn(__fmul_rn(k.mul, gy), k.a), __fmul_rn(k.b, xc));
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* q, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(q));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(q[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* q, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(q) = u;
  } else {
    q[0] = __float2bfloat16_rn(v[0]);
  }
}

// Sum of a and b over the block, in one order; thread 0 holds the result.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b) {
  __shared__ T sa[kWarps], sb[kWarps];
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sa[0];
    b = sb[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

// planar (NCHW): block (blockIdx.x, c) walks values [m0, m1) of channel c,
// value m = n * hw + pixel, VEC at a time (hw % VEC == 0, so a vector stays
// in one plane).
template <int PASS, int VEC>
__global__ void __launch_bounds__(kThreads) tail_planar_kernel(const TailArgs p) {
  const int c = blockIdx.y;
  const unsigned hw = (unsigned)p.hw;
  const unsigned m_end = (unsigned)p.n * hw;
  const unsigned m0 = blockIdx.x * (unsigned)p.span;
  const unsigned m1 = min(m0 + (unsigned)p.span, m_end);
  const Chan k = chan<PASS>(p, c);
  float s1 = 0.f, s2 = 0.f;
  for (unsigned m = m0 + threadIdx.x * VEC; m < m1; m += kThreads * VEC) {
    const unsigned nn = m / hw;
    const size_t off = ((size_t)nn * p.c + c) * hw + (m - nn * hw);
    const int kept = p.mask ? (int)p.mask[(size_t)nn * p.c + c] : -1;
    float xv[VEC], gv[VEC], r[VEC];
    load<VEC>(p.x + off, xv);
    if (PASS >= kGradStats) load<VEC>(p.g + off, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      r[i] = visit<PASS>(xv[i], PASS >= kGradStats ? gv[i] : 0.f, k, kept, p, s1, s2);
    if (PASS == kApply || PASS == kGrad) store<VEC>(p.out + off, r);
  }
  if (PASS == kStats || PASS == kGradStats) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) p.part[(size_t)c * p.parts + blockIdx.x] = make_float2(s1, s2);
  }
}

// rows (channels-last): x is [n * hw, c].  The block's tile of channel
// groups (VEC channels each, blockIdx.y) has gt groups; thread t owns group
// t % gt and walks rows r0 = t / gt, r0 + rb, ... of the block's span rows.
template <int PASS, int VEC>
__global__ void __launch_bounds__(kThreads) tail_rows_kernel(const TailArgs p) {
  const int groups = p.c / VEC;
  const int gt = min(groups, kThreads);
  const int rb = kThreads / gt;
  const int t = threadIdx.x;
  const int r0 = t / gt;
  const int cg = blockIdx.y * gt + t % gt;
  const int c0 = cg * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (r0 < rb && cg < groups) {
    Chan k[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) k[i] = chan<PASS>(p, c0 + i);
    const unsigned hw = (unsigned)p.hw;
    const unsigned r_begin = blockIdx.x * (unsigned)p.span;
    const unsigned r_end = min(r_begin + (unsigned)p.span, (unsigned)p.n * hw);
    for (unsigned r = r_begin + r0; r < r_end; r += rb) {
      const size_t off = (size_t)r * p.c + c0;
      const unsigned char* kp = p.mask ? p.mask + (size_t)(r / hw) * p.c + c0 : nullptr;
      float xv[VEC], gv[VEC], o[VEC];
      load<VEC>(p.x + off, xv);
      if (PASS >= kGradStats) load<VEC>(p.g + off, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = visit<PASS>(xv[i], PASS >= kGradStats ? gv[i] : 0.f, k[i],
                           kp ? (int)kp[i] : -1, p, s1[i], s2[i]);
      if (PASS == kApply || PASS == kGrad) store<VEC>(p.out + off, o);
    }
  }
  if (PASS == kStats || PASS == kGradStats) {
    __shared__ float sh1[kThreads * kMaxVec], sh2[kThreads * kMaxVec];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sh1[t * VEC + i] = s1[i];
      sh2[t * VEC + i] = s2[i];
    }
    __syncthreads();
    // channel j of the tile: thread (q, j / VEC)'s value i = j % VEC, q < rb
    const int width = gt * VEC;
    for (int j = t; j < width; j += kThreads) {
      const int ch = blockIdx.y * width + j;
      if (ch >= p.c) break;
      float a1 = 0.f, a2 = 0.f;
      for (int q = 0; q < rb; ++q) {
        a1 += sh1[q * width + j];
        a2 += sh2[q * width + j];
      }
      p.part[(size_t)ch * p.parts + blockIdx.x] = make_float2(a1, a2);
    }
  }
}

// One block a channel: its blocks' sums in float64, in one order.
__device__ __forceinline__ void channel_sums(const TailArgs& p, double& s1, double& s2) {
  const float2* part = p.part + (size_t)blockIdx.x * p.parts;
  s1 = 0.0;
  s2 = 0.0;
  for (int i = threadIdx.x; i < p.parts; i += kThreads) {
    const float2 v = part[i];
    s1 += v.x;
    s2 += v.y;
  }
  block_sum2(s1, s2);
}

__global__ void __launch_bounds__(kThreads) stats_final_kernel(const TailArgs p) {
  double s1, s2;
  channel_sums(p, s1, s2);
  if (threadIdx.x) return;
  const int c = blockIdx.x, nc = p.c;
  const double count = (double)p.n * p.hw;
  const float mean = (float)(s1 / count), ex2 = (float)(s2 / count);
  const float raw = __fsub_rn(ex2, __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  const float rstd = __frsqrt_rn(__fadd_rn(var, p.eps));
  p.stats[c] = mean;
  p.stats[nc + c] = __fmul_rn(rstd, p.weight[c]);
  p.stats[2 * nc + c] = rstd;
  p.stats[3 * nc + c] = raw >= 0.f ? 1.f : 0.f;
  p.stats[4 * nc + c] = __fadd_rn(__fmul_rn(p.run_mean[c], p.momentum), __fmul_rn(mean, p.rest));
  p.stats[5 * nc + c] = __fadd_rn(__fmul_rn(p.run_var[c], p.momentum), __fmul_rn(var, p.rest));
}

__global__ void __launch_bounds__(kThreads) grads_final_kernel(const TailArgs p) {
  double s1, s2;
  channel_sums(p, s1, s2);
  if (threadIdx.x) return;
  const int c = blockIdx.x, nc = p.c;
  const double count = (double)p.n * p.hw;
  const float mul = p.stats[nc + c], rstd = p.stats[2 * nc + c];
  p.grads[c] = __fmul_rn((float)s2, rstd);
  p.grads[nc + c] = (float)s1;
  p.grads[2 * nc + c] = (float)((double)mul * s1 / count);
  p.grads[3 * nc + c] =
      p.stats[3 * nc + c] != 0.f ? (float)((double)mul * rstd * rstd * s2 / count) : 0.f;
}

template <int PASS, int VEC>
void walk_vec(const TailArgs& p, int layout, cudaStream_t s) {
  if (layout == 0) {
    tail_planar_kernel<PASS, VEC><<<dim3(p.parts, p.c), kThreads, 0, s>>>(p);
  } else {
    const int groups = p.c / VEC, gt = groups < kThreads ? groups : kThreads;
    tail_rows_kernel<PASS, VEC><<<dim3(p.parts, (groups + gt - 1) / gt), kThreads, 0, s>>>(p);
  }
}

template <int PASS>
void walk(const TailArgs& p, int layout, int vec, cudaStream_t s) {
  if (vec == 8) {
    walk_vec<PASS, 8>(p, layout, s);
  } else {
    walk_vec<PASS, 1>(p, layout, s);
  }
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// The walk's geometry: the n * hw values of a channel (planar) or rows
// (rows) covered once, every block some, vectors inside a plane or a row.
bool valid(const TailArgs& p, int layout, int vec) {
  const long long extent = (long long)p.n * p.hw;
  if (p.n < 1 || p.c < 1 || p.hw < 1 || extent * p.c > INT_MAX || (layout != 0 && layout != 1) ||
      (vec != 1 && vec != 8) || p.span < 1 || p.parts < 1 ||
      (long long)p.parts * p.span < extent || (long long)(p.parts - 1) * p.span >= extent)
    return false;
  if (layout == 0 && (p.c > 65535 || p.span % vec || p.hw % vec)) return false;
  if (layout == 1 && (p.c % vec || (p.c / vec + kThreads - 1) / kThreads > 65535)) return false;
  return true;
}

}  // namespace

extern "C" {

// Forward.  x, out bf16 [n, c, hw] (layout 0) or [n * hw, c] (layout 1),
// dense; mask uint8 [n, c] or null; weight, bias, run_mean, run_var float32
// [c]; stats float32 [6, c] (written: mean, mul, rstd, live, running mean,
// running var); part float32 [c, parts, 2] scratch.  vec 8: x and out
// 16-byte aligned, hw (layout 0) or c (layout 1) a multiple of 8.  span:
// values of a channel (layout 0) or rows (layout 1) a block walks, parts
// blocks along the walk, so that parts * span covers it and every block has
// some.  Three launches.
int pcss_bn_train_forward(const void* x, void* out, const void* mask, const void* weight,
                          const void* bias, const void* run_mean, const void* run_var,
                          void* stats, void* part, int n, int c, int hw, int layout, int vec,
                          int span, int parts, float eps, float momentum, float rest,
                          float inv_keep, float slope, void* stream) {
  const TailArgs p{(const __nv_bfloat16*)x, nullptr, (__nv_bfloat16*)out,
                   (const unsigned char*)mask, (const float*)weight, (const float*)bias,
                   (const float*)run_mean, (const float*)run_var, (float*)stats, nullptr,
                   (float2*)part, n, c, hw, span, parts, eps, momentum, rest, inv_keep, slope};
  if (!valid(p, layout, vec) || (vec == 8 && !(aligned16(x) && aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  walk<kStats>(p, layout, vec, s);
  PCSS_CHECK_LAUNCH();
  stats_final_kernel<<<c, kThreads, 0, s>>>(p);
  PCSS_CHECK_LAUNCH();
  walk<kApply>(p, layout, vec, s);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// Backward.  x, g, dx bf16 in one storage as the forward's x; stats the
// forward's [6, c]; grads float32 [4, c] (written: dgamma, dbeta, A, B);
// part, mask, bias and the geometry as the forward's.  Three launches.
int pcss_bn_train_backward(const void* x, const void* g, void* dx, const void* mask,
                           const void* bias, const void* stats, void* grads, void* part, int n,
                           int c, int hw, int layout, int vec, int span, int parts,
                           float inv_keep, float slope, void* stream) {
  const TailArgs p{(const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx,
                   (const unsigned char*)mask, nullptr, (const float*)bias, nullptr, nullptr,
                   (float*)stats, (float*)grads, (float2*)part, n, c, hw, span, parts,
                   0.f, 0.f, 0.f, inv_keep, slope};
  if (!valid(p, layout, vec) || (vec == 8 && !(aligned16(x) && aligned16(g) && aligned16(dx))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  walk<kGradStats>(p, layout, vec, s);
  PCSS_CHECK_LAUNCH();
  grads_final_kernel<<<c, kThreads, 0, s>>>(p);
  PCSS_CHECK_LAUNCH();
  walk<kGrad>(p, layout, vec, s);
  PCSS_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
