// bf16 tensor-core building blocks shared by the whole-block kernels K2
// (convblock.cu::convblock_chw_tc_kernel) and K6
// (convblock128.cu::block128_tc_kernel): mma.sync m16n8k16 bf16 -> float32
// with ldmatrix fragments, cp.async copies, and the transposing stage that
// turns three channels-major rows into a pixel-major A operand.
//
// Both stage their input in place from the storage the caller has (enum
// Stage): channels-last (stage_rows_nhwc), channels-major with 16-byte reads
// along W (stage_rows), channels-major element by element
// (stage_rows_scalar; K6 only).
//
// Both kernels run kThreads threads (8 warps) on a tile of kTile output
// columns, the GEMM M.  Shared-memory tiles keep a row stride of (a
// multiple of 16) + 8 bf16 elements: the 8 rows of an ldmatrix then start 16
// bytes apart modulo 128 and fall in distinct banks.
#pragma once

#include "common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;       // threads per block: 8 warps
constexpr int kTile = 128;          // output columns per block (GEMM M)
constexpr int kStageW = kTile + 2;  // staged columns (one halo column each side)

// How a kernel stages its input x: channels-last, 16-byte reads along C (C %
// 8 == 0, x 16-byte aligned); channels-major, 16-byte reads along W (W % 8 ==
// 0, x 16-byte aligned); channels-major element by element.  The wrappers
// pick it from x's strides (ops/kernels/_build.py::stage_mode).
enum Stage { kNhwc = 0, kCmajorVec = 1, kCmajorScalar = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows x cols bf16 (global, row-major) into shared memory with row stride ld:
// 16-byte cp.async when cols % 8 == 0 (16-byte aligned rows), else element
// copies (visible after the next __syncthreads)
__device__ __forceinline__ void load_matrix(bf16* dst, int ld, const bf16* src, int rows,
                                            int cols) {
  if ((cols & 7) == 0) {
    const int per_row = cols >> 3;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) << 3;
      cp_async16(dst + r * ld + c, src + (size_t)r * cols + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = src[(size_t)r * cols + c];
    }
  }
}

// acc[mi][nj] += A (pixels pm + 16 mi .., K from a) x B (channels nb0 + 8 nj ..,
// rows of b) for k in [0, k_len); a and b already carry the lane's ldmatrix
// offset.  two: the warp owns 32 pixels (two m tiles), else 16.
__device__ __forceinline__ void mma_tile(float (&acc)[2][8][4], const bf16* a, int a_ld,
                                         const bf16* b, int b_ld, int k_len, int nb0, int npad,
                                         bool two) {
  for (int k0 = 0; k0 < k_len; k0 += 16) {
    uint32_t af[2][4];
    ldsm_x4(af[0], a + k0);
    if (two) ldsm_x4(af[1], a + 16 * a_ld + k0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nb = nb0 + jj * 16;
      if (nb < npad) {
        uint32_t bf[4];
        ldsm_x4(bf, b + nb * b_ld + k0);
        mma_bf16(acc[0][2 * jj], af[0], bf[0], bf[1]);
        mma_bf16(acc[0][2 * jj + 1], af[0], bf[2], bf[3]);
        if (two) {
          mma_bf16(acc[1][2 * jj], af[1], bf[0], bf[1]);
          mma_bf16(acc[1][2 * jj + 1], af[1], bf[2], bf[3]);
        }
      }
    }
  }
}

// Stage the rows row-1..row+1, columns col0-1..col0+kTile of kp channels of
// one channels-major image xn [C][H][W] (xn points at the first of them;
// channel stride sc and row stride sh in elements, columns contiguous; W % 8
// == 0, and xn, sc and sh 16-byte aligned) into xs [3][kStageW][cs],
// pixel-major.  Channels >= cin, rows outside [0, H) and columns outside
// [0, W) are zero.  A unit is 8 channels x 8 pixels, read as one 16-byte
// vector along W per channel and transposed in registers (prmt) into one
// 16-byte store per pixel; W % 8 == 0 puts a unit wholly inside or wholly
// outside the image.
__device__ __forceinline__ void stage_rows(bf16* xs, int cs, int kp, const bf16* xn, int cin,
                                           int h, int w, int row, int col0, size_t sc,
                                           size_t sh) {
  const int ncg = kp >> 3;
  for (int u = threadIdx.x; u < 3 * 16 * ncg; u += kThreads) {
    const int cg = u % ncg, pg = (u / ncg) & 15, r = u / (ncg * 16);
    const int gr = row + r - 1;
    const bool inside = gr >= 0 && gr < h && col0 + pg * 8 < w;
    uint32_t v[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg * 8 + j;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (inside && c < cin)
        q = *reinterpret_cast<const uint4*>(xn + (size_t)c * sc + (size_t)gr * sh + col0 +
                                            pg * 8);
      v[j][0] = q.x;
      v[j][1] = q.y;
      v[j][2] = q.z;
      v[j][3] = q.w;
    }
    bf16* dst = xs + (size_t)(r * kStageW + 1 + pg * 8) * cs + cg * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // pixel i: channel pairs from words i / 2
      const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
      uint4 o;
      o.x = __byte_perm(v[0][i >> 1], v[1][i >> 1], sel);
      o.y = __byte_perm(v[2][i >> 1], v[3][i >> 1], sel);
      o.z = __byte_perm(v[4][i >> 1], v[5][i >> 1], sel);
      o.w = __byte_perm(v[6][i >> 1], v[7][i >> 1], sel);
      *reinterpret_cast<uint4*>(dst + (size_t)i * cs) = o;
    }
  }
  // the halo columns col0 - 1 and col0 + kTile (zero outside [0, W))
  for (int u = threadIdx.x; u < 3 * 2 * kp; u += kThreads) {
    const int c = u % kp, s = (u / kp) & 1, r = u / (2 * kp);
    const int gr = row + r - 1, gc = s ? col0 + kTile : col0 - 1;
    bf16 val = __ushort_as_bfloat16((unsigned short)0);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w && c < cin)
      val = xn[(size_t)c * sc + (size_t)gr * sh + gc];
    xs[(size_t)(r * kStageW + (s ? kStageW - 1 : 0)) * cs + c] = val;
  }
}

// The same stage from channels-last storage xn [H][W][C] (row stride sh,
// pixel stride sw in elements, channels contiguous; cin % 8 == 0, and xn, sh
// and sw 16-byte aligned): 8 channels of a pixel are one 16-byte cp.async
// straight into their place in the stage, no transpose.  Channels >= cin,
// rows outside [0, H) and columns outside [0, W) are stored as zeros.  The
// caller commits the copies and waits for them before the stage is read.
__device__ __forceinline__ void stage_rows_nhwc(bf16* xs, int cs, int kp, const bf16* xn,
                                                int cin, int h, int w, int row, int col0,
                                                size_t sh, size_t sw) {
  const int ncg = kp >> 3;
  for (int u = threadIdx.x; u < 3 * kStageW * ncg; u += kThreads) {
    const int cg = u % ncg, col = (u / ncg) % kStageW, r = u / (ncg * kStageW);
    const int gr = row + r - 1, gc = col0 + col - 1;
    bf16* dst = xs + (size_t)(r * kStageW + col) * cs + cg * 8;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w && cg * 8 < cin)
      cp_async16(dst, xn + (size_t)gr * sh + (size_t)gc * sw + cg * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// The same stage element by element from channels-major storage xn
// [C][H][W] (channel stride sc, row stride sh, columns contiguous; no
// alignment asked), zeros as above.
__device__ __forceinline__ void stage_rows_scalar(bf16* xs, int cs, int kp, const bf16* xn,
                                                  int cin, int h, int w, int row, int col0,
                                                  size_t sc, size_t sh) {
  for (int u = threadIdx.x; u < 3 * kStageW * kp; u += kThreads) {
    const int col = u % kStageW, r = (u / kStageW) % 3, c = u / (3 * kStageW);
    const int gr = row + r - 1, gc = col0 + col - 1;
    bf16 val = __ushort_as_bfloat16((unsigned short)0);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w && c < cin)
      val = xn[(size_t)c * sc + (size_t)gr * sh + gc];
    xs[(size_t)(r * kStageW + col) * cs + c] = val;
  }
}

}  // namespace tc
