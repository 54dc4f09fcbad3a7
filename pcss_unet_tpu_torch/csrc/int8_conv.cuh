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
// same stream, and each block takes the max of k_rows + 2 of them.
//
// int8_taps_kernel<.., 9, ..> then computes, for one output row of TM pixels
// and TN output channels, an implicit GEMM on the int8 tensor cores
// (taps.cuh): the input channels are staged in slices of 32, quantized with
// their chunk's scale, and the nine taps of each slice run against its
// weights; the chunks' int32 sums are folded into float32 in order:
//   f = sum_j (f32(int32 tap sum of chunk j) * (a_j * s[m]))   (j = 0, 1, ...)
//   v = f + b[m], LeakyReLU if asked, stored as OT
// With one chunk this is exactly K3's and K7's f32(acc) * (a * s) + b.  When
// given a bandmax buffer it also takes the band's max |stored value| with an
// atomicMax on the float bits (non-negative floats order like their bits):
// the second scale of the whole-block kernels.  int8_taps_kernel<.., 1, ..>
// is the whole-block kernels' 1x1 on the same tile: one tap, slices of 128
// channels, the scale a2 = bandmax / 127 + 1e-12, and the same epilogue.
//
// Design (what bounds it: operations, see block_int8.cu / conv3x3_int8.cu):
// - warp-specialized: 8 consumer warps (4 x 2, each 32 pixels x 64 channels:
//   16 mma per two A and four B ldmatrix, the int32 fragment in registers)
//   and two producer warpgroups that stage the next slice meanwhile; 512
//   threads of 128 registers, one block per SM.  K5's float32 chunk sums
//   live in shared memory (64 KB), not in registers;
// - weight slices (9 taps x 32 channels x TN, 36 KB; 16 KB for the 1x1) come
//   by bulk asynchronous copies (cp.async.bulk, one per tap and 16-channel
//   word, spread over one warp's lanes, completing on an mbarrier) into two
//   buffers;
// - activation slices, double-buffered too, are read 16 channels a thread
//   at a time, several units' loads in flight together, and quantized as the
//   plain version does, bit for bit, without a division per value
//   (quant16_i8, common.cuh); producers and consumers hand buffers over
//   through hardware named barriers;
// - ragged edges: columns past W and channels past the chunk are staged as
//   zeros, weight rows past the tile's channels are zeroed once and never
//   copied, and the epilogue writes only real pixels and channels.
#pragma once

#include "common.cuh"
#include "taps.cuh"

namespace {

using namespace i8mma;

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

// mbarrier and bulk-copy (TMA without a tensor map) helpers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// hardware named barriers: a waiting warp takes no instruction slots
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
enum : int { kFull = 1, kEmpty = 3, kConsumers = 5 };  // named barrier ids (+ buffer)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct I8Args {
  const void* x;              // [n, h, w, c] T
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

// Dynamic shared memory: two activation slices, two weight slices, the
// chunked kernel's float32 chunk sums (one fragment of 64 per consumer
// thread), then float32 s[TN], b[TN] and one scale per chunk.
template <int TAPS, bool CHUNKED>
__host__ __device__ constexpr size_t taps_smem_bytes(int nchunks) {
  using S = Slice<TAPS>;
  return 2 * (size_t)S::XS_BYTES + 2 * (size_t)S::WS_BYTES +
         sizeof(float) * ((CHUNKED ? 64 * NT : 0) + 2 * TN + (size_t)nchunks);
}

// Stage activation slice words [wlo, wlo + KW) (zero at or past whi) of the
// rows and columns around (row, col0) into xs [ROWS][KW][XW][16], quantized
// by q; zero outside the frame.  Thread tid of NTHR takes units tid + NTHR*i,
// UB at a time: their loads are in flight together before any is quantized.
template <typename T, int TAPS, int UB, int NTHR>
__device__ __forceinline__ void stage_slice(int8_t* xs, const T* xn, int h, int w, int c,
                                            int row, int col0, int wlo, int whi,
                                            const Quant& q, int tid) {
  constexpr int KW = Slice<TAPS>::KW, UNITS = Slice<TAPS>::ROWS * KW * XW;
  constexpr int NU = (UNITS + NTHR - 1) / NTHR, VW = Words<T>::VW;
#pragma unroll 1
  for (int b0 = 0; b0 < NU; b0 += UB) {
    uint4 raw[UB][VW];
    bool ok[UB];
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = tid + NTHR * (b0 + i);
      const int k = u % KW, col = (u / KW) % XW, r = u / (KW * XW);
      const int gr = TAPS == 9 ? row + r - 1 : row, gc = col0 + col - 1;
      ok[i] = u < UNITS && gr >= 0 && gr < h && gc >= 0 && gc < w && wlo + k < whi &&
              (TAPS == 9 || (col >= 1 && col <= TM));
      if (ok[i]) load_words(xn + ((size_t)gr * w + gc) * c + (size_t)(wlo + k) * 16, raw[i]);
    }
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = tid + NTHR * (b0 + i);
      if (u < UNITS) {
        const int k = u % KW, col = (u / KW) % XW, r = u / (KW * XW);
        uint4 o = make_uint4(0, 0, 0, 0);
        if (ok[i]) {
          float v[16];
          unpack16(raw[i], v);
          o = quant16_i8(v, q.a, q.y, q.a24);
        }
        *reinterpret_cast<uint4*>(xs + ((size_t)(r * KW + k) * XW + col) * 16) = o;
      }
    }
  }
}

// grid (n * (co / split) * ceil(split / TN), ceil(w / TM), h): block (z, x,
// row) computes output row `row`, columns x*TM .., channels [n0, n1) of
// output channel group `split` (K7's co_tile; the whole co otherwise).  The
// channel tiles of one row tile are neighbours in launch order, so they find
// its input rows in L2.
//
// Warp roles, over the slices g (chunk g / spc; 32 input channels, 128 for
// the 1x1), each in buffer g & 1 of two:
// - producer warpgroups (threads NT .. NT + NP): once the consumers are done
//   with buffer g & 1 (named barrier kEmpty), one warp asks for weight slice
//   g by bulk copies, one per (tap, word) and lane, that complete on mbarrier
//   wbar; all NP threads read, quantize and store activation slice g; one
//   thread waits for the weights; then they arrive on named barrier kFull;
// - consumers (8 warps, threads 0 .. NT): wait on kFull, run the nine taps
//   (or one) of slice g on the tensor cores, arrive on kEmpty, fold a
//   finished chunk (K5); then the epilogue.
// Waiting warps sleep in the hardware barriers rather than spin, so the
// producers keep their instruction slots.
template <typename T, typename OT, int TAPS, bool CHUNKED>
__global__ void __launch_bounds__(NT + NP, 1) int8_taps_kernel(const I8Args A) {
  constexpr int KW = Slice<TAPS>::KW, XSB = Slice<TAPS>::XS_BYTES, WSB = Slice<TAPS>::WS_BYTES;
  // staging batch: units whose loads are in flight together
  constexpr int UB = sizeof(T) == 2 ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t wbar[2];  // weight slice of buffer b landed
  __shared__ float warp_max[NT / 32];
  int8_t* xsb = reinterpret_cast<int8_t*>(smem_raw);  // 2 x [ROWS][KW][XW][16]
  int8_t* wsb = xsb + 2 * XSB;                        // 2 x [TAPS][KW][TN][16]
  float* f_s = reinterpret_cast<float*>(wsb + 2 * WSB);  // CHUNKED: [64][NT]
  float* s_s = f_s + (CHUNKED ? 64 * NT : 0);
  float* b_s = s_s + TN;
  float* a_s = b_s + TN;

  const int h = A.h, w = A.w, c = A.c, cc = A.cc, co = A.co;
  const int nchunks = c / cc, cw16 = c / 16, ccw = (cc + 15) / 16;
  const int spc = (ccw + KW - 1) / KW, nslices = nchunks * spc;  // slices per chunk, in all
  const int tps = (A.split + TN - 1) / TN, ngroups = co / A.split;
  const int col0 = blockIdx.y * TM, row = blockIdx.z;
  const int n = blockIdx.x / (ngroups * tps), grp = (blockIdx.x / tps) % ngroups;
  const int n0 = grp * A.split + (blockIdx.x % tps) * TN;
  const int n1 = min(n0 + TN, (grp + 1) * A.split), nlim = n1 - n0;
  const int band = row / A.k_rows, nbands = h / A.k_rows;

  if (TAPS == 9) {
    for (int j = threadIdx.x; j < nchunks; j += NT + NP)
      a_s[j] = band_scale(A.rowmax, n, h, band, A.k_rows, nchunks, j);
  } else if (threadIdx.x == 0) {
    a_s[0] = __fadd_rn(__fdiv_rn(__uint_as_float(A.bandmax_in[n * nbands + band]), 127.f),
                       1e-12f);
  }
  for (int i = threadIdx.x; i < TN; i += NT + NP) {
    const bool real = i < nlim;
    s_s[i] = real ? A.s[n0 + i] : 0.f;
    b_s[i] = real ? A.b[n0 + i] : 0.f;
  }
  if (nlim < TN) {  // weight rows past the tile's channels: zero, never copied
    for (int i = threadIdx.x; i < 2 * TAPS * KW * TN; i += NT + NP)
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
    const T* xn = reinterpret_cast<const T*>(A.x) + (size_t)n * h * w * c;
#pragma unroll 1
    for (int g = 0; g < nslices; ++g) {
      const int j = g / spc, wlo = j * ccw + (g % spc) * KW, whi = (j + 1) * ccw;
      const uint32_t bar = smem_u32(&wbar[g & 1]);
      if (g >= 2) named_sync(kEmpty + (g & 1), NT + NP);  // consumers are done with slice g - 2
      if (pt < 32) {  // weight words [wlo, wlo + nw) of every tap, channels [n0, n1)
        const int nw = min(KW, whi - wlo);
        const uint32_t dst = smem_u32(wsb + (g & 1) * WSB);
        if (pt == 0) mbar_arrive_tx(bar, (uint32_t)(TAPS * nw * nlim * 16));
        __syncwarp();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int i = pt; i < TAPS * nw; i += 32) {  // one copy per (tap, word), by lane
          const int t = i / nw, k = i % nw;
          bulk_copy(dst + (t * KW + k) * TN * 16,
                    A.wp + ((size_t)t * cw16 + wlo + k) * co + n0, nlim * 16, bar);
        }
      }
      stage_slice<T, TAPS, UB, NP>(
          xsb + (g & 1) * XSB, xn, h, w, c, row, col0, wlo, whi, make_quant(a_s[j]), pt);
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
    const int j = g / spc, wlo = j * ccw + (g % spc) * KW;
    named_sync(kFull + (g & 1), NT + NP);
    conv_band_taps_mma<TAPS>(acc, xsb + (g & 1) * XSB, wsb + (g & 1) * WSB,
                                 min(KW, (j + 1) * ccw - wlo), pm, nb0, nlim, lane);
    if (g + 2 < nslices) named_arrive(kEmpty + (g & 1), NT + NP);
    if (CHUNKED && g % spc == spc - 1) {  // end of chunk j: fold into f in order
      const float a = a_s[j];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int m = nb0 + nj * 8 + 2 * q;
        const float sc0 = __fmul_rn(a, s_s[m]), sc1 = __fmul_rn(a, s_s[m + 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float part = __fmul_rn(__int2float_rn(acc[mi][nj][e]), (e & 1) ? sc1 : sc0);
            float& fe = f_s[((mi * 8 + nj) * 4 + e) * NT + threadIdx.x];
            fe = j == 0 ? part : __fadd_rn(fe, part);
            acc[mi][nj][e] = 0;
          }
      }
    }
  }

  // epilogue: + b, LeakyReLU, store as OT; max |stored| for the band
  OT* out = reinterpret_cast<OT*>(A.out);
  float omax = 0.f;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int m = nb0 + nj * 8 + 2 * q;  // channels m, m + 1 of the tile
    const float sc0 = CHUNKED ? 0.f : __fmul_rn(a_s[0], s_s[m]);
    const float sc1 = CHUNKED ? 0.f : __fmul_rn(a_s[0], s_s[m + 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = col0 + pm + mi * 16 + g4 + hf * 8;
        OT o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float fv =
              CHUNKED ? f_s[((mi * 8 + nj) * 4 + 2 * hf + e) * NT + threadIdx.x]
                      : __fmul_rn(__int2float_rn(acc[mi][nj][2 * hf + e]), e ? sc1 : sc0);
          float v = __fadd_rn(fv, b_s[m + e]);
          if (A.apply_leaky) v = leaky(v, A.slope);
          o[e] = from_float<OT>(v);
        }
        if (col < w) {
          OT* dst = out + (((size_t)n * h + row) * w + col) * co + n0 + m;
          if (m + 1 < nlim && ((co | n0) & 1) == 0) {  // an aligned pair
            if constexpr (sizeof(OT) == 4) {
              *reinterpret_cast<float2*>(dst) = make_float2(to_float(o[0]), to_float(o[1]));
            } else {
              __nv_bfloat162 p2;
              p2.x = o[0];
              p2.y = o[1];
              *reinterpret_cast<__nv_bfloat162*>(dst) = p2;
            }
            omax = fmaxf(omax, fmaxf(fabsf(to_float(o[0])), fabsf(to_float(o[1]))));
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (m + e < nlim) {
                dst[e] = o[e];
                omax = fmaxf(omax, fabsf(to_float(o[e])));
              }
          }
        }
      }
  }
  if (A.bandmax_out != nullptr) {  // uniform over the block; the consumers only
    for (int off = 16; off > 0; off >>= 1)
      omax = fmaxf(omax, __shfl_xor_sync(0xffffffffu, omax, off));
    if (lane == 0) warp_max[warp] = omax;
    named_sync(kConsumers, NT);
    if (threadIdx.x == 0) {
      for (int i = 1; i < NT / 32; ++i) omax = fmaxf(omax, warp_max[i]);
      atomicMax(&A.bandmax_out[n * nbands + band], __float_as_uint(omax));
    }
  }
}

// One int8_taps_kernel launch over all of A's rows and channels.  The
// largest plan (one scale per 16 channels of 1024) is allowed up front.
template <typename T, typename OT, int TAPS, bool CHUNKED>
int launch_taps(const I8Args& A, int n, cudaStream_t stream) {
  static unsigned done = 0;
  auto kernel = int8_taps_kernel<T, OT, TAPS, CHUNKED>;
  const int nchunks = A.c / A.cc;
  if (nchunks > 64) return (int)cudaErrorInvalidValue;
  const int e = allow_smem((const void*)kernel, taps_smem_bytes<TAPS, CHUNKED>(64), done);
  if (e) return e;
  const int tps = (A.split + TN - 1) / TN;
  const dim3 grid(n * (A.co / A.split) * tps, (A.w + TM - 1) / TM, A.h);
  kernel<<<grid, NT + NP, taps_smem_bytes<TAPS, CHUNKED>(nchunks), stream>>>(A);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// rowmax_kernel then the 3x3 on one stream; co is split into groups of
// `split` channels (K7's co_tile) that only divide the work.  MAY_CHUNK
// false builds only the one-chunk kernel (K7: cc == c).
template <typename T, typename OT, bool MAY_CHUNK>
int launch_conv3x3_int8(const void* x, const void* wp, const void* s, const void* b,
                        void* rowmax, void* bandmax, void* out, int n, int h, int w, int c, int cc,
                        int co, int split, int k_rows, float slope, int apply_leaky,
                        cudaStream_t stream) {
  const int nchunks = c / cc;
  rowmax_kernel<T><<<dim3(n * h, nchunks), 512, 0, stream>>>(
      (const T*)x, (float*)rowmax, (unsigned int*)bandmax, w, c, cc, h, k_rows);
  PCSS_CHECK_LAUNCH();
  const I8Args A{x, (const int4*)wp, (const float*)s, (const float*)b, (const float*)rowmax,
                 nullptr, (unsigned*)bandmax, out, h, w, c, cc, co, split, k_rows,
                 apply_leaky, slope};
  if (nchunks == 1) return launch_taps<T, OT, 9, false>(A, n, stream);
  if (!MAY_CHUNK) return (int)cudaErrorInvalidValue;
  return launch_taps<T, OT, 9, MAY_CHUNK>(A, n, stream);
}

}  // namespace
