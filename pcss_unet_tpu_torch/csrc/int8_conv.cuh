// The int8 stages shared by the int8 kernels: K3 (block_int8.cu,
// fused_block_int8_nhwc), K5 (block_int8.cu, fused_block_int8_kchunked) and
// K7 (conv3x3_int8.cu, conv3x3_int8_nhwc).
//
// Every one of them quantizes an NHWC input per row band of k_rows rows with
//   a = max|x over the band and one halo row above and below| / 127 + 1e-12
// (halo rows outside the frame count as zero), over all channels (K3, K7) or
// separately for each contraction chunk of cc channels (K5).  Blocks run in
// no order, so a band-wide max cannot be taken inside one block: it comes
// from a separate launch of per-row, per-chunk maxima (rowmax_kernel) on the
// same stream, and the band's scale is the max of k_rows + 2 of them.
//
// A second launch (rowmax_kernel_quant_bands) then quantizes every input
// once, into the band copy: for each band its k_rows + 2 rows (a row on a
// band edge is in both bands' copies, each time with that band's scale),
// each row as [words][wp][16] int8, the 16 channels of word k at column
// col of input column col - 1, wp = ceil(w / TM) * TM + 2.  Column 0, the
// columns past w and the halo rows outside the frame are zeros, exactly
// SAME padding; each chunk's words are rounded up to whole stages of KW
// words with zero words.  The quantization is the plain version's bit for
// bit, without a division per value (quant16_i8, common.cuh).
//
// int8_taps_kernel_wgmma then computes, for one output row of TM = 126
// pixels and TN = 256 output channels, the 3x3 as an implicit GEMM on
// Hopper's warpgroup MMA (taps.cuh, i8wg): the input channels are staged in
// slices of 32, one input row (dy) at a time, as bulk copies of the band
// copy, and each stage runs its three dx taps as wgmma m64n256k32, each
// consumer warpgroup on 64 rows of pixels; the chunks' int32 sums are folded
// into float32 in order:
//   f = sum_j (f32(int32 tap sum of chunk j) * (a_j * s[m]))   (j = 0, 1, ...)
//   v = f + b[m], LeakyReLU if asked, stored as OT
// With one chunk this is exactly K3's and K7's f32(acc) * (a * s) + b.  When
// given a bandmax buffer it also takes the band's max |stored value| with an
// atomicMax on the float bits (non-negative floats order like their bits):
// the second scale of the whole-block kernels.
//
// Design of the 3x3 (what bounds it: operations, see block_int8.cu /
// conv3x3_int8.cu; what bounds this kernel, measured: the weights' delivery
// from L2 into each SM, a stage's time growing with the L2 bytes a CTA reads,
// and each block's start and drain, PERF.md):
// - warp-specialized, 288 threads, one block per SM: two consumer
//   warpgroups, each with its 64 x 256 int32 accumulator in registers (128
//   a thread, of the 224 the launch bound leaves), and one producer warp
//   whose first thread asks for every stage by bulk copies (an L2 prefetch
//   of the block's rows at the start made K3 3-5 % slower, PERF.md);
// - clusters of two CTAs on adjacent pixel tiles: each stage's weights are
//   read from L2 once for both, by bulk copies multicast to both CTAs;
// - a ring of stages in shared memory (6 for one chunk, 3 for K5, whose
//   float32 chunk sums take 128 KB beside it), each one dy row of a 32-channel
//   slice: the weights of its three taps (24 KB, the packed [9][C/16][Cmid][16]
//   layout copied unchanged) and the activations (128 columns of two words
//   of the band copy, 2 KB contiguous a word), all completing on the stage's
//   "full" mbarrier, in the K-major core-matrix layout wgmma reads without
//   swizzle: a dx shift is 16 bytes of the descriptor's start;
// - consumers wait on a stage's "full" mbarrier, issue its three wgmma,
//   keep one stage's group in flight (wgmma.wait_group 1) and hand the
//   previous stage back on the "empty" mbarriers of both CTAs of the cluster;
// - the tensor cores' m64n256k32 takes 128 cycles of an SM and reads 10 KB
//   of shared memory (80 cycles); a stage brings 12 KB of weights from L2 (the
//   other 12 by the cluster's other CTA) and 4 KB of activations;
// - ragged edges: the band copy's zeros stand for columns past W and words
//   past a chunk, weight rows past the tile's channels are zeroed once and
//   never copied, and the epilogue writes only real pixels and channels; a
//   pixel tile past the frame (clusters round the tiles up) copies no
//   activations and stores nothing.
//
// int8_taps_kernel (the whole-block kernels' 1x1) stays on mma.sync: the
// scale a2 = bandmax / 127 + 1e-12, slices of 128 channels, 8 consumer warps
// (4 x 2, each 32 pixels x 64 channels) and two producer warpgroups over
// double buffers handed over through hardware named barriers, and the same
// epilogue.  It is under a fifth of the 3x3's operations.
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "taps.cuh"


namespace {

// 16 consecutive channels as float32 (16-byte aligned source), read as
// VW 16-byte words
template <typename T>
struct Words {
  static constexpr int VW = sizeof(T) == 2 ? 2 : 4;
};
__device__ __forceinline__ void unpack16(const uint4 (&q)[4], float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = __uint_as_float(q[i].x);
    v[4 * i + 1] = __uint_as_float(q[i].y);
    v[4 * i + 2] = __uint_as_float(q[i].z);
    v[4 * i + 3] = __uint_as_float(q[i].w);
  }
}
__device__ __forceinline__ void unpack16(const uint4 (&q)[2], float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t u[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bf16 -> float32 is exact: the bits, shifted
      v[8 * i + 2 * k] = __uint_as_float(u[k] << 16);
      v[8 * i + 2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
}
template <typename T>
__device__ __forceinline__ void load_words(const T* p, uint4 (&q)[Words<T>::VW]) {
#pragma unroll
  for (int i = 0; i < Words<T>::VW; ++i) q[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

// grid (n*h, c/cc): rowmax[(n*h + row) * nchunks + j] = max |x| over the row's
// w pixels and chunk j's cc channels, read 16 channels at a time.  Block
// (row, 0) of a band's first row also zeroes that band's bandmax entry, if
// bandmax is given.
template <typename T>
__global__ void rowmax_kernel(const T* __restrict__ x, float* __restrict__ rowmax,
                              unsigned int* __restrict__ bandmax, int w, int c, int cc, int h,
                              int k_rows) {
  const int j = blockIdx.y, nchunks = gridDim.y, cw = cc / 16;
  const T* xr = x + (size_t)blockIdx.x * w * c + (size_t)j * cc;
  float m = 0.f;
#pragma unroll 4
  for (int u = threadIdx.x; u < w * cw; u += blockDim.x) {
    uint4 q[Words<T>::VW];
    float v[16];
    load_words(xr + (size_t)(u / cw) * c + (u % cw) * 16, q);
    unpack16(q, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) m = fmaxf(m, fabsf(v[i]));
  }
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

// one activation scale a with y = RN(1/a) and a24 = a * 2^-24 (quant16_i8)
struct Quant {
  float a, y, a24;
};
__device__ __forceinline__ Quant make_quant(float a) {
  return Quant{a, __frcp_rn(a), __fmul_rn(a, 0x1p-24f)};
}

// The band copy's 16-byte words a row (each chunk's cc / 16 rounded up to
// whole stages) and its columns a row (whole pixel tiles and the two SAME
// columns).
__host__ __device__ constexpr int band_words(int c, int cc) {
  return c / cc * ((cc / 16 + i8wg::KW - 1) / i8wg::KW * i8wg::KW);
}
__host__ __device__ constexpr int band_cols(int w) {
  return (w + i8wg::TM - 1) / i8wg::TM * i8wg::TM + 2;
}

// grid (n * (h / k_rows) * (k_rows + 2) * ceil(words / 4)): block (R, q)
// writes words 4q .. 4q + 3 of row R = (n * nbands + band) * (k_rows + 2) + r
// of the band copy xq: input row band * k_rows + r - 1 quantized by the
// band's scale for each word's chunk, every column of band_cols(w).  Lane l
// of a warp takes word 4q + l % 4 of column 8i + l / 4, so a warp reads 128
// contiguous bytes of each of 8 pixels (bf16) and writes 128 contiguous
// bytes of each of its 4 words; QB columns a thread in flight.
template <typename T>
__global__ void __launch_bounds__(128) rowmax_kernel_quant_bands(
    const T* __restrict__ x, const float* __restrict__ rowmax, uint4* __restrict__ xq, int h,
    int w, int c, int cc, int k_rows) {
  constexpr int QB = 4;
  const int words = band_words(c, cc), wp = band_cols(w), nchunks = c / cc;
  const int quads = (words + 3) / 4, cpw = words / nchunks;
  const int k = blockIdx.x % quads * 4 + threadIdx.x % 4, rr = blockIdx.x / quads;
  const int r = rr % (k_rows + 2), nb = rr / (k_rows + 2), nbands = h / k_rows;
  const int n = nb / nbands, band = nb % nbands, j = k / cpw, kk = k % cpw;
  const int gr = band * k_rows + r - 1;
  if (k >= words) return;
  uint4* dst = xq + ((size_t)rr * words + k) * wp;
  // a word past the chunk, or a row outside the frame: zeros
  const bool live = kk * 16 < cc && gr >= 0 && gr < h;
  const Quant q = make_quant(live ? band_scale(rowmax, n, h, band, k_rows, nchunks, j) : 1.f);
  const T* src = x + ((size_t)n * h + (live ? gr : 0)) * w * c + (size_t)j * cc + kk * 16;
  const int step = (int)blockDim.x / 4;  // columns of the block a step
  for (int c0 = threadIdx.x / 4; c0 < wp; c0 += QB * step) {
    uint4 raw[QB][Words<T>::VW];
    bool ok[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      const int gc = c0 + i * step - 1;  // column col holds input column col - 1
      ok[i] = live && gc >= 0 && gc < w;
      if (ok[i]) load_words(src + (size_t)gc * c, raw[i]);
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      const int col = c0 + i * step;
      if (col < wp) {
        uint4 o = make_uint4(0, 0, 0, 0);
        if (ok[i]) {
          float v[16];
          unpack16(raw[i], v);
          o = quant16_i8(v, q.a, q.y, q.a24);
        }
        dst[col] = o;
      }
    }
  }
}

enum : int { kFull = 1, kEmpty = 3, kConsumers = 5 };  // named barrier ids (+ buffer)

struct I8Args {
  const void* x;              // 1x1: [n, h, w, c] T
  const uint4* xq;            // 3x3: the band copy [n][h/k_rows][k_rows+2][words][wp] int8 x 16
  const int4* wp;             // [TAPS][c/16][co][16] int8
  const float* s;             // [co] weight scales
  const float* b;             // [co] bias
  const float* rowmax;        // 3x3: [n*h*nchunks] row maxima
  const unsigned* bandmax_in; // 1x1: [n*h/k_rows] max |h| of each band (float bits)
  unsigned* bandmax_out;      // 3x3: the same, taken here; may be null
  void* out;                  // [n, h, w, co] OT
  int h, w, c, cc, co, split, k_rows, apply_leaky;
  float slope;
};

// Store channels m, m + 1 of one pixel at dst (those below nlim; one paired
// store where `pairs` says the pair is aligned) and return max |stored|.
template <typename OT>
__device__ __forceinline__ float store_pair(OT* dst, const OT (&o)[2], int m, int nlim,
                                            bool pairs) {
  if (m + 1 < nlim && pairs) {
    if constexpr (sizeof(OT) == 4) {
      *reinterpret_cast<float2*>(dst) = make_float2(to_float(o[0]), to_float(o[1]));
    } else {
      __nv_bfloat162 p2;
      p2.x = o[0];
      p2.y = o[1];
      *reinterpret_cast<__nv_bfloat162*>(dst) = p2;
    }
    return fmaxf(fabsf(to_float(o[0])), fabsf(to_float(o[1])));
  }
  float mx = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (m + e < nlim) {
      dst[e] = o[e];
      mx = fmaxf(mx, fabsf(to_float(o[e])));
    }
  return mx;
}

// The max of omax over consumer threads 0 .. nthreads into *dst (float bits)
__device__ __forceinline__ void band_max_atomic(float omax, float* warp_max, int nthreads,
                                                unsigned* dst) {
  for (int off = 16; off > 0; off >>= 1)
    omax = fmaxf(omax, __shfl_xor_sync(0xffffffffu, omax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = omax;
  named_sync(kConsumers, nthreads);
  if (threadIdx.x == 0) {
    for (int i = 1; i < nthreads / 32; ++i) omax = fmaxf(omax, warp_max[i]);
    atomicMax(dst, __float_as_uint(omax));
  }
}

// ------------------------------------------------------------ the 3x3 (wgmma)

template <bool CHUNKED>
__host__ __device__ constexpr int wg_stages() {
  return CHUNKED ? 3 : 6;
}

// Dynamic shared memory: the ring, the chunked kernel's float32 chunk sums
// (128 per consumer thread), then float32 s[TN], b[TN] and one scale per
// chunk.
template <bool CHUNKED>
__host__ __device__ constexpr size_t wg_smem_bytes(int nchunks) {
  return (size_t)wg_stages<CHUNKED>() * i8wg::STAGE_BYTES +
         sizeof(float) * ((CHUNKED ? 128 * i8wg::NC : 0) + 2 * i8wg::TN + (size_t)nchunks);
}

// grid (n * (co / split) * ceil(split / TN), ceil(w / TM) rounded up to
// whole clusters, h): block (z, x, row) computes output row `row`, columns
// x*TM .. x*TM + TM (those inside the frame), channels [n0, n1) of
// output channel group `split` (K7's co_tile; the whole co otherwise).  The
// channel tiles of one row tile are neighbours in launch order, so they find
// its input rows in L2.
//
// Stage g is (slice g / 3, dy = g % 3); slice l holds words wlo .. wlo + 1
// of chunk l / spc.  Stage g lives in ring buffer g % STAGES:
// - the producer warp's first thread (thread NC), once the consumers of the
//   whole cluster have handed buffer g % STAGES back (its "empty" mbarrier),
//   asks for stage g: this CTA's share of the three taps' weight words by
//   bulk copies multicast to both CTAs of the cluster, and the stage's two
//   words of band copy row row % k_rows + dy, 128 columns from col0, by two
//   bulk copies, all completing on each CTA's "full" mbarrier;
// - each consumer warpgroup (threads 0 .. NC) waits on "full", issues the
//   stage's three wgmma on its 64 pixels, waits until only this stage's are
//   in flight, hands the previous buffer back to every CTA of the cluster,
//   and at the end of a chunk (K5) folds its sums into f in order.  Then the
//   epilogue.
// The cluster's CTAs are adjacent pixel tiles of one row and channel tile,
// so they read the same weights; each waits for the other before exiting.
template <typename OT, bool CHUNKED>
__global__ void __cluster_dims__(1, i8wg::CLUSTER, 1) __launch_bounds__(i8wg::NC + i8wg::NP, 1)
    int8_taps_kernel_wgmma(const I8Args A) {
  using namespace i8wg;
  constexpr int STAGES = wg_stages<CHUNKED>(), RING_W = 3 * KW * TN;
  extern __shared__ __align__(128) unsigned char smem_ring[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float warp_max[NC / 32];
  unsigned char* ring = smem_ring;  // STAGES x {ws [3][KW][TN][16], xs [KW][XW][16]}
  float* f_s = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);  // CHUNKED: [128][NC]
  float* s_s = f_s + (CHUNKED ? 128 * NC : 0);
  float* b_s = s_s + TN;
  float* a_s = b_s + TN;

  const int h = A.h, w = A.w, c = A.c, cc = A.cc, co = A.co;
  const int nchunks = c / cc, cw16 = c / 16, ccw = cc / 16;
  const int spc = (ccw + KW - 1) / KW, chunk_steps = 3 * spc, nsteps = nchunks * chunk_steps;
  const int tps = (A.split + TN - 1) / TN, ngroups = co / A.split;
  const int col0 = blockIdx.y * TM, row = blockIdx.z;
  const int n = blockIdx.x / (ngroups * tps), grp = (blockIdx.x / tps) % ngroups;
  const int n0 = grp * A.split + (blockIdx.x % tps) * TN;
  const int n1 = min(n0 + TN, (grp + 1) * A.split), nlim = n1 - n0;
  const int band = row / A.k_rows, nbands = h / A.k_rows;

  for (int j = threadIdx.x; j < nchunks; j += NC + NP)
    a_s[j] = band_scale(A.rowmax, n, h, band, A.k_rows, nchunks, j);
  for (int i = threadIdx.x; i < TN; i += NC + NP) {
    const bool real = i < nlim;
    s_s[i] = real ? A.s[n0 + i] : 0.f;
    b_s[i] = real ? A.b[n0 + i] : 0.f;
  }
  if (nlim < TN) {  // weight rows past the tile's channels: zero, never copied
    for (int i = threadIdx.x; i < STAGES * RING_W; i += NC + NP)
      if (i % TN >= nlim)
        *reinterpret_cast<uint4*>(ring + (i / RING_W) * STAGE_BYTES + (i % RING_W) * 16) =
            make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);  // the producer's expect_tx
      // one arrival per consumer warpgroup of the cluster: the buffer's
      // weights are written into every CTA of it
      mbar_init(smem_u32(&empty[s]), NC / 128 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no CTA copies into or arrives on another's barriers before they exist
  const uint32_t rank = cluster_rank();

  if (threadIdx.x >= NC) {  // ---------------------------------------- producer
    const int words = band_words(c, cc), bcols = band_cols(w), cpw = words / nchunks;
    const bool live = col0 < w;  // a tile past the frame copies no activations
    // word 0 of this block's band copy row row % k_rows + dy, column col0, at
    // xb + dy * words * bcols; word k of a row is k * bcols further
    const size_t r0 = (size_t)(n * nbands + band) * (A.k_rows + 2) + row % A.k_rows;
    const uint4* xb = A.xq + r0 * words * bcols + col0;
    if (threadIdx.x == NC) {
#pragma unroll 1
      for (int g = 0; g < nsteps; ++g) {
        const int sl = g / 3, dy = g % 3, j = sl / spc, kw0 = (sl % spc) * KW;
        const int wlo = j * ccw + kw0, nw = min(KW, ccw - kw0);
        unsigned char* st = ring + (g % STAGES) * STAGE_BYTES;
        const uint32_t bar = smem_u32(&full[g % STAGES]);
        if (g >= STAGES) mbar_wait(smem_u32(&empty[g % STAGES]), (g / STAGES - 1) & 1);
        mbar_arrive_tx(bar, (uint32_t)(3 * nw * nlim * 16 + (live ? KW * XS_COLS * 16 : 0)));
        // weight words [wlo, wlo + nw) of taps 3 dy .. 3 dy + 2, channels
        // [n0, n1): this CTA's share of the copies, multicast to the cluster
        for (int i = rank; i < 3 * nw; i += CLUSTER) {
          const int dx = i / nw, k = i % nw;
          bulk_copy_multicast(smem_u32(st) + (dx * KW + k) * TN * 16,
                              A.wp + ((size_t)(3 * dy + dx) * cw16 + wlo + k) * co + n0,
                              nlim * 16, bar, (1u << CLUSTER) - 1);
        }
        if (live)  // words j * cpw + kw0 .. + KW of the band copy (zero past the chunk)
          for (int k = 0; k < KW; ++k)
            bulk_copy(smem_u32(st + WS_BYTES) + k * XW * 16,
                      xb + ((size_t)dy * words + j * cpw + kw0 + k) * bcols, XS_COLS * 16, bar);
      }
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------------ consumers
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, v = (threadIdx.x >> 5) & 3;
    const int g4 = lane >> 2, q = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    const uint32_t ring_u = smem_u32(ring);
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    int owed = -1;  // a buffer whose products are done but not yet handed back
#pragma unroll 1
    for (int g = 0; g < nsteps; ++g) {
      const int s = g % STAGES;
      mbar_wait(smem_u32(&full[s]), (g / STAGES) & 1);
      const uint32_t st = ring_u + s * STAGE_BYTES;
      wg_fence();
      conv_row_taps(d, st + WS_BYTES, st, 64 * wg, g % chunk_steps == 0);
      wg_commit();
      wg_wait<1>();
      if (owed >= 0 && leader)
        for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(smem_u32(&empty[owed]), r);
      owed = s;
      if (CHUNKED && g % chunk_steps == chunk_steps - 1) {  // end of chunk j: fold into f in order
        wg_wait<0>();
        fence_operands(d);
        if (leader)
          for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(smem_u32(&empty[s]), r);
        owed = -1;
        const int j = g / chunk_steps;
        const float a = a_s[j];
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {
          const int m = 8 * jj + 2 * q;
          const float sc0 = __fmul_rn(a, s_s[m]), sc1 = __fmul_rn(a, s_s[m + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            const float part = __fmul_rn(__int2float_rn(d[i]), (e & 1) ? sc1 : sc0);
            float& fe = f_s[i * NC + threadIdx.x];
            fe = j == 0 ? part : __fadd_rn(fe, part);
          }
        }
      }
    }
    wg_wait<0>();
    fence_operands(d);

    // epilogue: + b, LeakyReLU, store as OT; max |stored| for the band
    OT* out = reinterpret_cast<OT*>(A.out);
    const int p = 64 * wg + 16 * v + g4;  // the thread's rows p, p + 8 (pixels below TM)
    const bool pairs = ((co | n0) & 1) == 0;
    float omax = 0.f;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int m = 8 * jj + 2 * q;  // channels m, m + 1 of the tile
      const float sc0 = CHUNKED ? 0.f : __fmul_rn(a_s[0], s_s[m]);
      const float sc1 = CHUNKED ? 0.f : __fmul_rn(a_s[0], s_s[m + 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = col0 + p + 8 * hf;
        OT o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hf + e;
          const float fv = CHUNKED ? f_s[i * NC + threadIdx.x]
                                   : __fmul_rn(__int2float_rn(d[i]), e ? sc1 : sc0);
          float val = __fadd_rn(fv, b_s[m + e]);
          if (A.apply_leaky) val = leaky(val, A.slope);
          o[e] = from_float<OT>(val);
        }
        if (p + 8 * hf < TM && col < w)
          omax = fmaxf(omax, store_pair(out + (((size_t)n * h + row) * w + col) * co + n0 + m, o,
                                        m, nlim, pairs));
      }
    }
    if (A.bandmax_out != nullptr)  // uniform over the block; the consumers only
      band_max_atomic(omax, warp_max, NC, &A.bandmax_out[n * nbands + band]);
  }
  cluster_sync();  // no CTA exits while another may still arrive on its barriers
}

// One int8_taps_kernel_wgmma launch over all of A's rows and channels.  The
// largest plan (one scale per 16 channels of 1024) is allowed up front.
template <typename OT, bool CHUNKED>
int launch_taps_wgmma(const I8Args& A, int n, cudaStream_t stream) {
  static unsigned done = 0;
  auto kernel = int8_taps_kernel_wgmma<OT, CHUNKED>;
  const int nchunks = A.c / A.cc;
  if (nchunks > 64) return (int)cudaErrorInvalidValue;
  const int e = allow_smem((const void*)kernel, wg_smem_bytes<CHUNKED>(64), done);
  if (e) return e;
  const int tps = (A.split + i8wg::TN - 1) / i8wg::TN;
  // pixel tiles rounded up to whole clusters; a tile past the frame stores nothing
  const int tiles = (A.w + i8wg::TM * i8wg::CLUSTER - 1) / (i8wg::TM * i8wg::CLUSTER);
  const dim3 grid(n * (A.co / A.split) * tps, tiles * i8wg::CLUSTER, A.h);
  kernel<<<grid, i8wg::NC + i8wg::NP, wg_smem_bytes<CHUNKED>(nchunks), stream>>>(A);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// ------------------------------------------------------- the 1x1 (mma.sync)

// Dynamic shared memory: two activation slices, two weight slices, then
// float32 s[TN], b[TN].
constexpr size_t pointwise_smem_bytes() {
  return 2 * (size_t)i8mma::XS_BYTES + 2 * (size_t)i8mma::WS_BYTES + sizeof(float) * 2 * i8mma::TN;
}

// Stage words [wlo, wlo + KW) (zero at or past whi) of row xr's columns
// col0 .. col0 + TM into columns 1 .. TM of xs [KW][XW][16], quantized by q;
// zero past the frame.  Thread tid of NTHR takes units tid + NTHR*i, UB at
// a time: their loads are in flight together before any is quantized.
template <typename T, int UB, int NTHR>
__device__ __forceinline__ void stage_pointwise(int8_t* xs, const T* xr, int w, int c, int col0,
                                                int wlo, int whi, const Quant& q, int tid) {
  using namespace i8mma;
  constexpr int UNITS = KW * XW, NU = (UNITS + NTHR - 1) / NTHR, VW = Words<T>::VW;
#pragma unroll 1
  for (int b0 = 0; b0 < NU; b0 += UB) {
    uint4 raw[UB][VW];
    bool ok[UB];
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = tid + NTHR * (b0 + i);
      const int k = u % KW, col = u / KW, gc = col0 + col - 1;
      ok[i] = u < UNITS && col >= 1 && col <= TM && gc < w && wlo + k < whi;
      if (ok[i]) load_words(xr + (size_t)gc * c + (size_t)(wlo + k) * 16, raw[i]);
    }
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = tid + NTHR * (b0 + i);
      if (u < UNITS) {
        const int k = u % KW, col = u / KW;
        uint4 o = make_uint4(0, 0, 0, 0);
        if (ok[i]) {
          float v[16];
          unpack16(raw[i], v);
          o = quant16_i8(v, q.a, q.y, q.a24);
        }
        *reinterpret_cast<uint4*>(xs + ((size_t)k * XW + col) * 16) = o;
      }
    }
  }
}

// grid (n * ceil(co / TN), ceil(w / TM), h): block (z, x, row) computes the
// 1x1 of output row `row`, columns x*TM .., channels [n0, n0 + TN) of h's
// quantization by the band's a2.  Warp roles, over the slices g of 128
// channels, each in buffer g & 1 of two:
// - producer warpgroups (threads NT .. NT + NP): once the consumers are done
//   with buffer g & 1 (named barrier kEmpty), one warp asks for weight slice
//   g by bulk copies, one per word and lane, that complete on mbarrier wbar;
//   all NP threads read, quantize and store activation slice g; one thread
//   waits for the weights; then they arrive on named barrier kFull;
// - consumers (8 warps, threads 0 .. NT): wait on kFull, run slice g on the
//   tensor cores, arrive on kEmpty; then the epilogue.
// Waiting warps sleep in the hardware barriers rather than spin, so the
// producers keep their instruction slots.
template <typename T, typename OT>
__global__ void __launch_bounds__(i8mma::NT + i8mma::NP, 1) int8_taps_kernel(const I8Args A) {
  using namespace i8mma;
  // staging batch: units whose loads are in flight together
  constexpr int UB = sizeof(T) == 2 ? 4 : 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t wbar[2];  // weight slice of buffer b landed
  __shared__ float warp_max[NT / 32];
  __shared__ float a2;
  int8_t* xsb = reinterpret_cast<int8_t*>(smem_raw);  // 2 x [KW][XW][16]
  int8_t* wsb = xsb + 2 * XS_BYTES;                   // 2 x [KW][TN][16]
  float* s_s = reinterpret_cast<float*>(wsb + 2 * WS_BYTES);
  float* b_s = s_s + TN;

  const int h = A.h, w = A.w, c = A.c, co = A.co, cw16 = c / 16;
  const int nslices = (cw16 + KW - 1) / KW, tiles = (co + TN - 1) / TN;
  const int col0 = blockIdx.y * TM, row = blockIdx.z;
  const int n = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * TN, nlim = min(TN, co - n0);
  const int band = row / A.k_rows, nbands = h / A.k_rows;

  if (threadIdx.x == 0)
    a2 = __fadd_rn(__fdiv_rn(__uint_as_float(A.bandmax_in[n * nbands + band]), 127.f), 1e-12f);
  for (int i = threadIdx.x; i < TN; i += NT + NP) {
    const bool real = i < nlim;
    s_s[i] = real ? A.s[n0 + i] : 0.f;
    b_s[i] = real ? A.b[n0 + i] : 0.f;
  }
  if (nlim < TN) {  // weight rows past the tile's channels: zero, never copied
    for (int i = threadIdx.x; i < 2 * KW * TN; i += NT + NP)
      if (i % TN >= nlim) reinterpret_cast<uint4*>(wsb)[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&wbar[0]), 1);
    mbar_init(smem_u32(&wbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NT) {  // ---------------------------------------- producers
    const int pt = threadIdx.x - NT;
    const T* xr = reinterpret_cast<const T*>(A.x) + ((size_t)n * h + row) * w * c;
    const Quant qa = make_quant(a2);
#pragma unroll 1
    for (int g = 0; g < nslices; ++g) {
      const int wlo = g * KW;
      const uint32_t bar = smem_u32(&wbar[g & 1]);
      if (g >= 2) named_sync(kEmpty + (g & 1), NT + NP);  // consumers are done with slice g - 2
      if (pt < 32) {  // weight words [wlo, wlo + nw), channels [n0, n0 + nlim)
        const int nw = min(KW, cw16 - wlo);
        const uint32_t dst = smem_u32(wsb + (g & 1) * WS_BYTES);
        if (pt == 0) mbar_arrive_tx(bar, (uint32_t)(nw * nlim * 16));
        __syncwarp();
        fence_async_smem();
        if (pt < nw)  // one copy per word, by lane
          bulk_copy(dst + pt * TN * 16, A.wp + (size_t)(wlo + pt) * co + n0, nlim * 16, bar);
      }
      stage_pointwise<T, UB, NP>(xsb + (g & 1) * XS_BYTES, xr, w, c, col0, wlo, cw16, qa, pt);
      if (pt == 0) mbar_wait(bar, (g >> 1) & 1);  // the weights have landed
      __syncwarp();
      named_arrive(kFull + (g & 1), NT + NP);
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pm = (warp & 3) * WM, nb0 = (warp >> 2) * WN;
  const int g4 = lane >> 2, q = lane & 3;
  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

#pragma unroll 1
  for (int g = 0; g < nslices; ++g) {
    named_sync(kFull + (g & 1), NT + NP);
    conv_1x1_mma(acc, xsb + (g & 1) * XS_BYTES, wsb + (g & 1) * WS_BYTES,
                 min(KW, cw16 - g * KW), pm, nb0, nlim, lane);
    if (g + 2 < nslices) named_arrive(kEmpty + (g & 1), NT + NP);
  }

  // epilogue: + b, LeakyReLU, store as OT; max |stored| for the band
  OT* out = reinterpret_cast<OT*>(A.out);
  const bool pairs = ((co | n0) & 1) == 0;
  float omax = 0.f;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int m = nb0 + nj * 8 + 2 * q;  // channels m, m + 1 of the tile
    const float sc0 = __fmul_rn(a2, s_s[m]), sc1 = __fmul_rn(a2, s_s[m + 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = col0 + pm + mi * 16 + g4 + hf * 8;
        OT o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][nj][2 * hf + e]), e ? sc1 : sc0),
                              b_s[m + e]);
          if (A.apply_leaky) v = leaky(v, A.slope);
          o[e] = from_float<OT>(v);
        }
        if (col < w)
          omax = fmaxf(omax, store_pair(out + (((size_t)n * h + row) * w + col) * co + n0 + m,
                                        o, m, nlim, pairs));
      }
  }
  if (A.bandmax_out != nullptr)  // uniform over the block; the consumers only
    band_max_atomic(omax, warp_max, NT, &A.bandmax_out[n * nbands + band]);
}

// One 1x1 int8_taps_kernel launch over all of A's rows and channels.
template <typename T, typename OT>
int launch_pointwise(const I8Args& A, int n, cudaStream_t stream) {
  static unsigned done = 0;
  auto kernel = int8_taps_kernel<T, OT>;
  const int e = allow_smem((const void*)kernel, pointwise_smem_bytes(), done);
  if (e) return e;
  const dim3 grid(n * ((A.co + i8mma::TN - 1) / i8mma::TN), (A.w + i8mma::TM - 1) / i8mma::TM,
                  A.h);
  kernel<<<grid, i8mma::NT + i8mma::NP, pointwise_smem_bytes(), stream>>>(A);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// rowmax_kernel, then rowmax_kernel_quant_bands into xq, on one stream.
template <typename T>
int launch_quant_bands(const void* x, void* rowmax, void* bandmax, void* xq, int n, int h, int w,
                       int c, int cc, int k_rows, cudaStream_t stream) {
  const int nchunks = c / cc;
  rowmax_kernel<T><<<dim3(n * h, nchunks), 512, 0, stream>>>(
      (const T*)x, (float*)rowmax, (unsigned int*)bandmax, w, c, cc, h, k_rows);
  PCSS_CHECK_LAUNCH();
  const long long blocks =
      (long long)n * (h / k_rows) * (k_rows + 2) * ((band_words(c, cc) + 3) / 4);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rowmax_kernel_quant_bands<T><<<(unsigned)blocks, 128, 0, stream>>>(
      (const T*)x, (const float*)rowmax, (uint4*)xq, h, w, c, cc, k_rows);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// The band copy, then the 3x3 on one stream; co is split into groups of
// `split` channels (K7's co_tile) that only divide the work.  MAY_CHUNK
// false builds only the one-chunk kernel (K7: cc == c).
template <typename T, typename OT, bool MAY_CHUNK>
int launch_conv3x3_int8(const void* x, const void* wp, const void* s, const void* b,
                        void* rowmax, void* bandmax, void* xq, void* out, int n, int h, int w,
                        int c, int cc, int co, int split, int k_rows, float slope,
                        int apply_leaky, cudaStream_t stream) {
  const int nchunks = c / cc;
  if (nchunks > 1 && !MAY_CHUNK) return (int)cudaErrorInvalidValue;
  const int e = launch_quant_bands<T>(x, rowmax, bandmax, xq, n, h, w, c, cc, k_rows, stream);
  if (e) return e;
  const I8Args A{nullptr, (const uint4*)xq, (const int4*)wp, (const float*)s, (const float*)b,
                 (const float*)rowmax, nullptr, (unsigned*)bandmax, out, h, w, c, cc, co,
                 split, k_rows, apply_leaky, slope};
  if (nchunks == 1) return launch_taps_wgmma<OT, false>(A, n, stream);
  return launch_taps_wgmma<OT, MAY_CHUNK>(A, n, stream);
}

}  // namespace
