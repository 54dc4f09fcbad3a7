// The banded resize behind ops/resize.py::apply_matrix: every align-corners
// resize of the port (the decoder's 2x upsamples, the head's folded
// 544 -> 1088 -> 544 chains, the channels-major engine's zero-padded chains,
// the windows and row shards' cut matrices) and, on transposed tables, its
// gradient.
//
// It replaces no TPU kernel.  The JAX package bands the same products for the
// TPU's matrix unit in jnp (ops/resize.py::banded_apply: dense dots over each
// block's input window); the port's first version kept one dense float32
// matmul per axis ([out, in] x [.., in, ..]), which on this card ran without
// tensor cores at ~234 GFLOP a w64 frame for 2-3 nonzeros a row.
//
//   out[n, o, j] = round_T( sum_{k < NB} w[o, k] * x[n, start[o] + k, j] )
//
// over the tensor read as [outer, L, inner] along the resized axis in its
// own memory order (no transposing copy; the wrapper writes the output in
// the same order).  w holds the matrix entries already rounded to x's type
// (the reference's cast point); each product and each partial sum is one
// IEEE rounding (__fmul_rn, __fadd_rn, from 0, in increasing k), so the
// kernel equals ops/kernels/resize.py::banded_resize_plain bit for bit, and
// the dense product to within one rounding of T (it only adds exact zeros in
// another order).  A float64 tensor (the parity nets) sums in float64 and
// rounds each result to float32, as the reference's float32 result type
// does.
//
// Bound by bytes (3.35 TB/s): each input value is read NB times from L2 at
// most and once from memory, each output written once.  A w64 1088x1920
// frame's eight calls move ~1.0 GB, ~0.3 ms.  What the design does:
//   - inner >= 8 (cols mode: the H axis of NCHW, both axes of channels-last):
//     each thread loads and stores 16 bytes (8 bf16, 4 float32, 2 float64) along
//     inner, neighbouring threads on neighbouring addresses;
//   - inner == 1 (rows mode: the W axis of contiguous NCHW): a warp keeps
//     the band tables of 256 outputs in registers and walks 8 rows; for each
//     it stages the input segment those outputs read in shared memory as
//     float32 (16-byte loads, padded against bank conflicts), then each
//     lane writes 8 contiguous outputs (16-byte stores where aligned);
//   - anything else (an unaligned base, inner not a multiple of the vector):
//     cols mode one value a thread.
// One launch a call, on the caller's stream; the kernel allocates nothing.
#include "common.cuh"

#include <cuda_fp16.h>
#include <limits.h>

namespace {

constexpr int kMaxBand = 4;
constexpr int kColsThreads = 256;
constexpr int kRowsWarps = 4;                           // warps a block
constexpr int kRowsLoop = 8;                            // rows a warp
constexpr int kRowsPer = 8;                             // outputs a lane
constexpr int kRowsTile = 32 * kRowsPer;                // outputs a warp
constexpr int kRowsSeg = kRowsTile * kMaxBand;          // staged inputs a warp

// Storage of T as raw bits, converted to and from its accumulator (float32,
// float64 for double) by intrinsics.
template <typename T> struct Io;
template <> struct Io<float> {
  using Raw = unsigned int;
  using Acc = float;
  static __device__ __forceinline__ float load(Raw r) { return __uint_as_float(r); }
  static __device__ __forceinline__ Raw store(float v) { return __float_as_uint(v); }
};
template <> struct Io<__nv_bfloat16> {
  using Raw = unsigned short;
  using Acc = float;
  static __device__ __forceinline__ float load(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ Raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Io<__half> {
  using Raw = unsigned short;
  using Acc = float;
  static __device__ __forceinline__ float load(Raw r) { return __half2float(__ushort_as_half(r)); }
  static __device__ __forceinline__ Raw store(float v) { return __half_as_ushort(__float2half_rn(v)); }
};
template <> struct Io<double> {
  using Raw = unsigned long long;
  using Acc = double;
  static __device__ __forceinline__ double load(Raw r) { return __longlong_as_double((long long)r); }
  static __device__ __forceinline__ Raw store(double v) {
    return (Raw)__double_as_longlong((double)__double2float_rn(v));
  }
};

// acc + w * v, the product and the sum each rounded once
__device__ __forceinline__ float mul_add(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}
__device__ __forceinline__ double mul_add(double acc, double w, double v) {
  return __dadd_rn(acc, __dmul_rn(w, v));
}

template <typename Raw> union Pack16 {
  uint4 u;
  Raw e[16 / sizeof(Raw)];
};

struct BandArgs {
  const void* x;
  void* out;
  const int* start;     // [l_out]
  const float* weight;  // [l_out, NB]
  int outer, l_in, l_out, inner;
};

// VEC consecutive values at p (16-byte aligned where VEC * size is 16).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const typename Io<T>::Raw* p,
                                         typename Io<T>::Acc (&v)[VEC]) {
  using Raw = typename Io<T>::Raw;
  if constexpr (VEC * sizeof(Raw) == 16) {
    Pack16<Raw> pk;
    pk.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = Io<T>::load(pk.e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = Io<T>::load(__ldg(p + i));
  }
}

// cols mode: thread t owns VEC consecutive inner values of one (n, o).
template <typename T, int NB, int VEC>
__global__ void __launch_bounds__(kColsThreads) band_cols_kernel(const BandArgs a) {
  using Raw = typename Io<T>::Raw;
  using Acc = typename Io<T>::Acc;
  const unsigned chunks = (unsigned)a.inner / VEC;
  const unsigned t = blockIdx.x * (unsigned)kColsThreads + threadIdx.x;
  if (t >= (unsigned)a.outer * (unsigned)a.l_out * chunks) return;
  const unsigned row = t / chunks, c = t - row * chunks;
  const unsigned n = row / (unsigned)a.l_out, o = row - n * (unsigned)a.l_out;
  const int s = __ldg(a.start + o);
  const Raw* x = static_cast<const Raw*>(a.x) +
                 ((long long)n * a.l_in + s) * a.inner + (long long)c * VEC;
  Acc acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const Acc w = __ldg(a.weight + o * NB + k);
    Acc v[VEC];
    load_vec<T, VEC>(x + (long long)k * a.inner, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = mul_add(acc[i], w, v[i]);
  }
  Raw* out = static_cast<Raw*>(a.out) + (long long)row * a.inner + (long long)c * VEC;
  if constexpr (VEC * sizeof(Raw) == 16) {
    Pack16<Raw> pk;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pk.e[i] = Io<T>::store(acc[i]);
    *reinterpret_cast<uint4*>(out) = pk.u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = Io<T>::store(acc[i]);
  }
}

// Shared-memory index of staged input i: one pad word every 32, so that
// lanes reading 8 outputs apart at 0.5, 1 or 2 inputs an output (the 2x up,
// the head's chain, the 2x up's transpose) hit 32 different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

// rows mode (inner == 1): a warp computes outputs [o0, o0 + 256) of 8
// consecutive rows, 8 contiguous outputs a lane (a block holds 4 warps).
// The band tables of its 256 outputs are the same for every row, so each
// lane loads its starts and weights once; for each row the warp stages the
// inputs [base, hi) its outputs read in its shared memory in the
// accumulator's type (16 bytes a lane where the row is aligned), when they
// fit (a tile reads at most 4 inputs an output through the tables the port
// builds), else reads them from global.  A lane's outputs past the row's
// end (its last tile) read at the warp's first start with weight 0 and are
// not stored.
template <typename T, int NB>
__global__ void __launch_bounds__(32 * kRowsWarps) band_rows_kernel(const BandArgs a) {
  using Raw = typename Io<T>::Raw;
  using Acc = typename Io<T>::Acc;
  constexpr int kPerPack = 16 / sizeof(Raw);
  // room for [base, hi) rounded up to whole packs
  __shared__ Acc seg_all[kRowsWarps][padded(kRowsSeg + 2 * kPerPack)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n0 = ((long long)blockIdx.x * kRowsWarps + warp) * kRowsLoop;
  if (n0 >= a.outer) return;  // the whole warp: no block-wide barrier follows
  Acc* seg = seg_all[warp];
  const int o0 = blockIdx.y * kRowsTile;
  const int o_end = min(o0 + kRowsTile, a.l_out);
  const int first = o0 + lane * kRowsPer;
  int s[kRowsPer];
  float w[kRowsPer][NB];
  int lo = INT_MAX, hi = 0;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int o = first + j;
    const bool live = o < o_end;
    s[j] = live ? __ldg(a.start + o) : 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) w[j][k] = live ? __ldg(a.weight + o * NB + k) : 0.f;
    if (live) {
      lo = min(lo, s[j]);
      hi = max(hi, s[j] + NB);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int base = lo - lo % kPerPack;
  // a dead output reads inside [lo, lo + NB), within [base, hi) and the row
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j)
    if (first + j >= o_end) s[j] = lo;
  const bool staged = hi - base <= kRowsSeg + kPerPack;
  const long long n_end = n0 + kRowsLoop < a.outer ? n0 + kRowsLoop : (long long)a.outer;
  for (long long n = n0; n < n_end; ++n) {
    const Raw* x = static_cast<const Raw*>(a.x) + n * a.l_in;
    if (staged) {
      if (a.l_in % kPerPack == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
        // [base, hi) rounded up to whole packs stays inside the row
        const int packs = (hi - base + kPerPack - 1) / kPerPack;
        for (int p = lane; p < packs; p += 32) {
          Pack16<Raw> pk;
          pk.u = __ldg(reinterpret_cast<const uint4*>(x + base) + p);
#pragma unroll
          for (int e = 0; e < kPerPack; ++e) seg[padded(p * kPerPack + e)] = Io<T>::load(pk.e[e]);
        }
      } else {
        for (int i = lane; i < hi - base; i += 32) seg[padded(i)] = Io<T>::load(__ldg(x + base + i));
      }
      __syncwarp();
    }
    if (first < o_end) {
      Raw r[kRowsPer];
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        Acc acc = 0;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const Acc v = staged ? seg[padded(s[j] - base + k)] : Io<T>::load(__ldg(x + s[j] + k));
          acc = mul_add(acc, (Acc)w[j][k], v);
        }
        r[j] = Io<T>::store(acc);
      }
      Raw* out = static_cast<Raw*>(a.out) + n * a.l_out + first;
      if (first + kRowsPer <= o_end && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
#pragma unroll
        for (int p = 0; p < kRowsPer / kPerPack; ++p) {
          Pack16<Raw> pk;
#pragma unroll
          for (int i = 0; i < kPerPack; ++i) pk.e[i] = r[p * kPerPack + i];
          reinterpret_cast<uint4*>(out)[p] = pk.u;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRowsPer; ++j)
          if (first + j < o_end) out[j] = r[j];
      }
    }
    __syncwarp();  // the next row's staging overwrites seg
  }
}

template <typename T, int NB>
void launch_band(const BandArgs& a, int mode, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(typename Io<T>::Raw);
  if (mode == 2) {
    constexpr int kRowsBlock = kRowsWarps * kRowsLoop;
    const dim3 grid((a.outer + kRowsBlock - 1) / kRowsBlock, (a.l_out + kRowsTile - 1) / kRowsTile);
    band_rows_kernel<T, NB><<<grid, 32 * kRowsWarps, 0, s>>>(a);
    return;
  }
  const long long threads = (long long)a.outer * a.l_out * (a.inner / (mode == 1 ? kVec : 1));
  const unsigned blocks = (unsigned)((threads + kColsThreads - 1) / kColsThreads);
  if (mode == 1) {
    band_cols_kernel<T, NB, kVec><<<blocks, kColsThreads, 0, s>>>(a);
  } else {
    band_cols_kernel<T, NB, 1><<<blocks, kColsThreads, 0, s>>>(a);
  }
}

template <typename T>
void launch_typed(const BandArgs& a, int nb, int mode, cudaStream_t s) {
  switch (nb) {
    case 1: launch_band<T, 1>(a, mode, s); break;
    case 2: launch_band<T, 2>(a, mode, s); break;
    case 3: launch_band<T, 3>(a, mode, s); break;
    default: launch_band<T, 4>(a, mode, s); break;
  }
}

}  // namespace

extern "C" {

// x [outer, l_in, inner] and out [outer, l_out, inner] in memory (dense);
// start [l_out] int32 with start + nb <= l_in; weight [l_out, nb] float32.
// dtype 0 float32, 1 bfloat16, 2 float16, 3 float64 (results rounded to
// float32).  mode 0: cols, one value a
// thread; 1: cols, 16 bytes a thread (inner a multiple of 16 bytes, x and
// out 16-byte aligned); 2: rows (inner == 1).
int pcss_band_resize(const void* x, void* out, const void* start, const void* weight, int outer,
                     int l_in, int l_out, int inner, int nb, int dtype, int mode, void* stream) {
  const int vec = dtype == 0 ? 4 : dtype == 3 ? 2 : 8;
  if (outer < 1 || l_in < 1 || l_out < 1 || inner < 1 || nb < 1 || nb > kMaxBand || nb > l_in ||
      dtype < 0 || dtype > 3 || mode < 0 || mode > 2 || (mode == 1 && inner % vec) ||
      (mode == 2 && inner != 1) || (long long)outer * l_in * inner > INT_MAX ||
      (long long)outer * l_out * inner > INT_MAX ||
      (mode == 2 && (l_out + kRowsTile - 1) / kRowsTile > 65535))
    return (int)cudaErrorInvalidValue;
  const BandArgs a{x, out, (const int*)start, (const float*)weight, outer, l_in, l_out, inner};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_typed<float>(a, nb, mode, s);
  } else if (dtype == 1) {
    launch_typed<__nv_bfloat16>(a, nb, mode, s);
  } else if (dtype == 2) {
    launch_typed<__half>(a, nb, mode, s);
  } else {
    launch_typed<double>(a, nb, mode, s);
  }
  PCSS_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
