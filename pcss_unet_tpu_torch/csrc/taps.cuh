// The 3x3 SAME tap contraction shared by the int8 NHWC row-band kernels
// (counterpart of pcss_unet_tpu/ops/pallas/taps.py::conv3x3_band_taps and of
// its plain version pcss_unet_tpu_torch/ops/kernels/taps.py), on Hopper's
// int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, fragments by ldmatrix.
//
// One block computes a GEMM tile of TM output pixels (consecutive columns of
// one row) by TN output channels; K is taps x input channels, staged KW
// 16-byte words (16 channels each) at a time.  Shared-memory layouts, both
// word-major so that the 8 rows of every ldmatrix are 128 contiguous bytes
// (no bank conflicts) and every dx shift stays 16-byte aligned:
//   xs [ROWS][KW][XW][16]  int8 activations; ROWS = 3 (input rows r-1..r+1)
//                          for 9 taps, 1 for the 1x1; column j is input column
//                          col0 + j - 1.  The caller stages zeros outside the
//                          frame, which is exactly SAME padding.
//   ws [TAPS][KW][TN][16]  int8 weights, one 16-byte word per (tap, word,
//                          output channel): the K-contiguous B operand of
//                          mma .row.col, as pack_taps_i8 lays it out globally.
// Tap t = dy*3 + dx + 1 with dy in {0,1,2} (staged row) and dx in {-1,0,1}:
// the order of an HWIO kernel reshaped to [9, C, Co], as the reference uses.
// int8 x int8 -> int32 sums are exact in any order, so the tap and channel
// order inside one contraction chunk does not change a bit of the result.
#pragma once

#include "common.cuh"

namespace i8mma {

constexpr int TM = 128;      // output pixels per block
constexpr int TN = 128;      // output channels per block
constexpr int XW = TM + 2;   // staged columns (one halo column each side)
constexpr int NT = 256;      // consumer threads: 8 warps, 4 along pixels x 2 along channels
constexpr int NP = 256;      // producer threads: two warpgroups
constexpr int WM = 32;       // warp tile: 32 pixels (two m16 tiles) ...
constexpr int WN = 64;       // ... x 64 channels (eight n8 tiles)

// 16-byte words of input channels per staged slice: 32 channels for the 3x3
// (nine taps per word), 128 for the 1x1
template <int TAPS>
struct Slice {
  static constexpr int KW = TAPS == 9 ? 2 : 8;
  static constexpr int ROWS = TAPS == 9 ? 3 : 1;
  static constexpr int XS_BYTES = ROWS * KW * XW * 16;
  static constexpr int WS_BYTES = TAPS * KW * TN * 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices (8 rows of 16 bytes each); lane l gives the address
// of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][nj] += sum over the TAPS taps and the slice's first `words` words
// of xs * ws, for the warp's pixels pm + 16 mi + (0..15) and channels
// nb0 + 8 nj + (0..7) of the tile.  Channel groups of 16 at or past `nlim`
// (the tile's real channels) are skipped: their weights are zero.  Words
// past `words` up to the next even count must be zero in xs or ws.
//   acc fragment (m16n8 s32): [0], [1] pixel g, channels 2q, 2q+1;
//   [2], [3] pixel g + 8 (g = lane / 4, q = lane % 4)
template <int TAPS>
__device__ __forceinline__ void conv_band_taps_mma(int (&acc)[2][8][4], const int8_t* xs,
                                                   const int8_t* ws, int words, int pm,
                                                   int nb0, int nlim, int lane) {
  constexpr int KW = Slice<TAPS>::KW;
  // A: lanes 0-15 rows (pixels) 0-15 of the low word, lanes 16-31 the high
  // word; B: lanes 0-7 / 8-15 channels 0-7 of the low / high word, lanes
  // 16-31 channels 8-15
  const uint32_t xa = smem_u32(xs) + ((lane >> 4) * XW + pm + (lane & 15)) * 16;
  const uint32_t wa =
      smem_u32(ws) + (((lane >> 3) & 1) * TN + nb0 + (lane & 7) + ((lane >> 4) << 3)) * 16;
#pragma unroll 1
  for (int t = 0; t < TAPS; ++t) {
    const int dy = TAPS == 9 ? t / 3 : 0, dxp1 = TAPS == 9 ? t % 3 : 1;
    const uint32_t xt = xa + (dy * KW * XW + dxp1) * 16;
    const uint32_t wt = wa + t * KW * TN * 16;
#pragma unroll
    for (int kk = 0; kk < KW / 2; ++kk) {
      if (2 * kk < words) {
        uint32_t af[2][4];
        ldsm_x4(af[0], xt + 2 * kk * XW * 16);
        ldsm_x4(af[1], xt + (2 * kk * XW + 16) * 16);
#pragma unroll
        for (int jj = 0; jj < WN / 16; ++jj) {
          if (nb0 + jj * 16 < nlim) {
            uint32_t bf[4];
            ldsm_x4(bf, wt + (2 * kk * TN + jj * 16) * 16);
            mma_s8(acc[0][2 * jj], af[0], bf[0], bf[1]);
            mma_s8(acc[0][2 * jj + 1], af[0], bf[2], bf[3]);
            mma_s8(acc[1][2 * jj], af[1], bf[0], bf[1]);
            mma_s8(acc[1][2 * jj + 1], af[1], bf[2], bf[3]);
          }
        }
      }
    }
  }
}

}  // namespace i8mma
