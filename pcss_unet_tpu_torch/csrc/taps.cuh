// The tap contractions of the int8 NHWC row-band kernels (counterpart of
// pcss_unet_tpu/ops/pallas/taps.py::conv3x3_band_taps and of its plain
// version pcss_unet_tpu_torch/ops/kernels/taps.py) on Hopper's int8 tensor
// cores, s8 x s8 -> s32:
//
// - i8wg: the 3x3, on warpgroup MMA (wgmma.mma_async m64n256k32, both
//   operands read from shared memory through matrix descriptors);
// - i8mma: the whole-block kernels' 1x1, on mma.sync m16n8k32 with
//   fragments by ldmatrix.
//
// Both read the same two shared-memory layouts, made of 8-row x 16-byte
// core matrices (16 input channels of 8 consecutive pixels or output
// channels, 128 contiguous bytes: no bank conflicts, and a shift of one
// pixel keeps every row 16-byte aligned):
//   activations [words][columns][16] int8; column j is input column
//                col0 + j - 1, so tap dx of output pixel p reads column
//                p + dx + 1.  Zeros outside the frame (the 3x3 copies them
//                from the band copy, the 1x1's producers stage them) are
//                exactly SAME padding.
//   weights     [taps][words][channels][16] int8, one 16-byte word per
//                (tap, word, output channel): the K-contiguous B operand, as
//                pack_taps_i8 lays it out globally, so bulk copies move it
//                unchanged.
// Tap t = dy*3 + dx + 1 with dy in {0,1,2} (input row r - 1 + dy) and dx in
// {-1,0,1}: the order of an HWIO kernel reshaped to [9, C, Co], as the
// reference uses.  int8 x int8 -> int32 sums are exact in any order, so the
// tap and channel order inside one contraction chunk does not change a bit
// of the result.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace i8wg {

// One block: one output row, TM pixels (two 64-row halves, one per consumer
// warpgroup; rows TM, TM + 1 read the two unstaged columns and are never
// stored) x TN output channels.  K runs over stages of one dy row and KW
// words (32 input channels, wgmma's k32): three wgmma a stage, one per dx,
// each against that tap's weights.
constexpr int TM = 126;                         // output pixels stored per block
constexpr int TN = 256;                         // output channels per block
constexpr int XS_COLS = TM + 2;                 // staged columns: one bulk copy of 2 KB a word
constexpr int XW = 130;                         // columns the two 64-row halves' three taps read
constexpr int KW = 2;                           // 16-byte words per stage
constexpr int NC = 256;                         // consumer threads: two warpgroups
constexpr int NP = 32;                          // producer threads: one warp, one of them copies
constexpr int XS_BYTES = KW * XW * 16;          // activations of a stage
constexpr int WS_BYTES = 3 * KW * TN * 16;      // weights of a stage: 3 taps
constexpr int STAGE_BYTES = WS_BYTES + (XS_BYTES + 127) / 128 * 128;
constexpr int CLUSTER = 2;                      // CTAs along the pixel tiles sharing weights

// keep the compiler from moving reads of the accumulators across a wait
__device__ __forceinline__ void fence_operands(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= a (64 x 32 s8, K-major) * b (32 x 256 s8, K-major), int32; d is
// overwritten when `accumulate` is 0.  Thread l of warp v of the warpgroup
// holds d[4j + 2h + e]: row 16v + l/4 + 8h, column 8j + 2(l%4) + e.
__device__ __forceinline__ void mma_64x256(int (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The three dx taps of one stage for the warpgroup's 64 pixels (starting
// at pixel p0 of the tile): xs [KW][XW][16], ws [3][KW][TN][16].
__device__ __forceinline__ void conv_row_taps(int (&d)[128], uint32_t xs, uint32_t ws, int p0,
                                              bool first) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
    mma_64x256(d, wg_desc(xs + (p0 + dx) * 16, XW * 16, 128),
               wg_desc(ws + dx * KW * TN * 16, TN * 16, 128), first && dx == 0 ? 0 : 1);
}

}  // namespace i8wg

namespace i8mma {

// The 1x1: one block computes TM pixels (consecutive columns of one row) x
// TN output channels, K = input channels staged KW words at a time.
constexpr int TM = 128;      // output pixels per block
constexpr int TN = 128;      // output channels per block
constexpr int XW = TM + 2;   // staged columns (the halo columns stay unused)
constexpr int KW = 8;        // 16-byte words per slice: 128 channels
constexpr int NT = 256;      // consumer threads: 8 warps, 4 along pixels x 2 along channels
constexpr int NP = 256;      // producer threads: two warpgroups
constexpr int WM = 32;       // warp tile: 32 pixels (two m16 tiles) ...
constexpr int WN = 64;       // ... x 64 channels (eight n8 tiles)
constexpr int XS_BYTES = KW * XW * 16;
constexpr int WS_BYTES = KW * TN * 16;

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

// acc[mi][nj] += sum over the slice's first `words` words of xs * ws, for
// the warp's pixels pm + 16 mi + (0..15) and channels nb0 + 8 nj + (0..7) of
// the tile.  Channel groups of 16 at or past `nlim` (the tile's real
// channels) are skipped: their weights are zero.  Words past `words` up to
// the next even count must be zero in xs or ws.
//   acc fragment (m16n8 s32): [0], [1] pixel g, channels 2q, 2q+1;
//   [2], [3] pixel g + 8 (g = lane / 4, q = lane % 4)
__device__ __forceinline__ void conv_1x1_mma(int (&acc)[2][8][4], const int8_t* xs,
                                             const int8_t* ws, int words, int pm, int nb0,
                                             int nlim, int lane) {
  // A: lanes 0-15 rows (pixels) 0-15 of the low word, lanes 16-31 the high
  // word; B: lanes 0-7 / 8-15 channels 0-7 of the low / high word, lanes
  // 16-31 channels 8-15.  Column 1 holds the tile's first pixel.
  const uint32_t xa = smem_u32(xs) + ((lane >> 4) * XW + pm + (lane & 15) + 1) * 16;
  const uint32_t wa =
      smem_u32(ws) + (((lane >> 3) & 1) * TN + nb0 + (lane & 7) + ((lane >> 4) << 3)) * 16;
#pragma unroll
  for (int kk = 0; kk < KW / 2; ++kk) {
    if (2 * kk < words) {
      uint32_t af[2][4];
      ldsm_x4(af[0], xa + 2 * kk * XW * 16);
      ldsm_x4(af[1], xa + (2 * kk * XW + 16) * 16);
#pragma unroll
      for (int jj = 0; jj < WN / 16; ++jj) {
        if (nb0 + jj * 16 < nlim) {
          uint32_t bf[4];
          ldsm_x4(bf, wa + (2 * kk * TN + jj * 16) * 16);
          mma_s8(acc[0][2 * jj], af[0], bf[0], bf[1]);
          mma_s8(acc[0][2 * jj + 1], af[0], bf[2], bf[3]);
          mma_s8(acc[1][2 * jj], af[1], bf[0], bf[1]);
          mma_s8(acc[1][2 * jj + 1], af[1], bf[2], bf[3]);
        }
      }
    }
  }
}

}  // namespace i8mma
