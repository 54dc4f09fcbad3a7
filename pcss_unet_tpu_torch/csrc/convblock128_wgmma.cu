// K6's bf16 block on Hopper's warpgroup MMA: block128_tc_kernel_wgmma, the
// whole folded ConvBlock of convblock128.cu (pcss_unet_tpu/ops/pallas/
// convblock128.py::fused_block128_nhwc) for the shapes the w64 net's dec_2
// gives it:
//
//   out = leaky(cast(leaky(conv3x3_SAME(x, W1) + b1)) · W2 + b2), cast to bf16
//
// on x [N, H, W, 128] bf16 in dense, 16-byte aligned channels-last storage,
// Cout % 8 == 0 and Cout <= 128; the output is channels-last.  Products of
// bf16 values sum in float32, the hidden value is rounded to bf16 before the
// 1x1, as in block128_tc_kernel, which keeps every other bf16 input.
//
// What bounds it on the H100: at dec_2 (x [1,544,960,128], Cout 64) the
// block does 81.3 G multiply-adds, 0.1644 ms at the 989 TFLOP/s bf16
// tensor-core rate, and moves ~0.2 GB of x and output through HBM:
// operations.  The mma.sync kernel read 15 % of that bound; it read all
// 311 KB of weights from L2 for every 128 pixels (~1.35 GB a frame).  This
// one takes 0.254 ms there, 65 % of the bound, and 0.974 ms at N = 4 (H100
// SXM, 700 W; PERF.md).
//
// Design:
// - a tile is 240 output pixels of one row (960 = 4 tiles); the 3x3 is a GEMM
//   with M = the 128 hidden channels (A: the weights), N = the 240 pixels
//   (B: the activations) and K = 9 taps x 128 channels, on wgmma m64n240k16,
//   one consumer warpgroup per 64 hidden channels, its 64 x 240 float32 sums
//   in registers (120 a thread);
// - a ring of STAGES stages in shared memory, each one dy row of a 32-channel
//   slice: the three dx taps' weights [dx][4][128][8] (24 KB) and the
//   activations [4][XPS][8] (16-byte channel groups of the row's 242
//   columns); a dx tap is the B descriptor's start moved by 16 bytes.  Both
//   operands are the K-major layout without swizzle (8-row x 16-byte core
//   matrices), as the int8 3x3 reads them;
// - one producer warp, one thread of which asks for every stage: the weights
//   by bulk copies of the packed slices, half by each CTA of a cluster of two
//   neighbouring tiles and multicast to both, and the activations by the TMA
//   from a tensor map of x, one box of 8 channels x 242 columns per channel
//   group; the box's columns and rows outside the frame read as zero, which
//   is the SAME padding.  Each stage completes on its "full" mbarrier; the
//   consumers of both CTAs hand it back on its "empty" mbarriers;
// - after the last tap: + b1, leaky, rounded to bf16 into the hidden tile
//   [16][240][8] (the 1x1's B operand); the 1x1 is wgmma m64n240k16 from it
//   against W2 [16][op][8], which comes through the ring as a 13th stage of
//   the tile, one warpgroup per 64 output channels; + b2, leaky, bf16 into an
//   output tile [240][136] over the hidden tile, then 16-byte stores of
//   the tile's columns inside the frame;
// - a persistent grid: each cluster walks over its pairs of tiles (n, row,
//   pair) while the producer runs ahead into the next tile's stages, so a
//   tile's epilogue overlaps the next one's loads.
// Weight bytes read from L2 a dec_2 frame: 544 rows x 2 pairs x 311 KB (each
// slice read once for both tiles of a pair) = 0.34 GB.  Tried and not kept
// (PERF.md): clusters of 4 tiles, 3 stages, 64-channel stages, L2 promotion.
#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 128;                       // input and hidden channels
constexpr int NG = C / 8;                    // 16-byte channel groups of C
constexpr int TP = 240;                      // output pixels a tile: the wgmma N
constexpr int XP = TP + 2;                   // input columns a tile reads: the TMA box
constexpr int XPS = 248;                     // columns of a channel group in a stage: 3,968 B
constexpr int KC = 32;                       // input channels a stage
constexpr int KG = KC / 8;                   // channel groups a stage
constexpr int STAGES = 4;
constexpr int CONV_STAGES = 3 * (C / KC);    // (channel slice, dy) stages of the 3x3 a tile
constexpr int TILE_STAGES = CONV_STAGES + 1; // then W2
constexpr int WS_BYTES = 3 * KG * C * 16;    // a stage's weights [dx][KG][C][8]
constexpr int XS_BYTES = KG * XPS * 16;      // a stage's activations [KG][XPS][8]
constexpr int STAGE_BYTES = WS_BYTES + XS_BYTES;
constexpr int MAX_OP = 128;                  // output channels, padded to whole m64 blocks
constexpr int OSTR = MAX_OP + 8;             // row stride (bf16) of the output tile
constexpr int HID_BYTES = TP * OSTR * 2;     // hidden tile [NG][TP][8], then output tile [TP][OSTR]
constexpr int NC = 256;                      // consumer threads: two warpgroups
constexpr int NP = 32;                       // producer threads: one warp
constexpr int CLUSTER = 2;                   // neighbouring tiles sharing the weights
constexpr int SMEM = STAGES * STAGE_BYTES + HID_BYTES + 2 * STAGES * 8 + 128;
constexpr int kTile = 1;                     // named barrier of the consumers
static_assert(NG * TP * 16 <= HID_BYTES && STAGE_BYTES % 128 == 0 && XPS * 16 % 128 == 0 &&
                  NG * MAX_OP * 16 <= STAGE_BYTES && SMEM <= 232448,
              "shared-memory plan");

// d (+)= a (64 x 16 bf16, K-major) * b (16 x 240 bf16, K-major), float32; d
// is overwritten when `accumulate` is 0.  Thread l of warp v of the
// warpgroup holds d[4j + 2h + e]: row 16v + l/4 + 8h, column 8j + 2(l%4) + e.
__device__ __forceinline__ void mma_64x240(float (&d)[120], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
      : "l"(da), "l"(db), "r"(accumulate));
}

// four 8x8 b16 matrices stored transposed: r[i] holds the thread's two
// elements (row l/4, columns 2(l%4), 2(l%4) + 1) of matrix i, and lane l gives
// the address of row l % 8 of the transposed matrix l / 8 (16 bytes: column
// l % 8 of matrix l / 8)
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
                   "r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// leaky(v + b) for two values, rounded to bf16 and packed (the first low)
__device__ __forceinline__ uint32_t bias_leaky_bf16x2(float v0, float v1, float b, float slope) {
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(leaky(__fadd_rn(v0, b), slope), leaky(__fadd_rn(v1, b), slope));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// keep the compiler from moving reads of the accumulators across a wait
__device__ __forceinline__ void fence_operands(float (&d)[120]) {
#pragma unroll
  for (int i = 0; i < 120; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct WgArgs {
  const bf16* w1p;  // [C/KC][3 dy][3 dx][KG][C][8]: stage g's weights at g * WS_BYTES
  const bf16* w2p;  // [NG][op][8], rows Cout..op zero
  const float* b1;  // [C]
  const float* b2;  // [cout]
  bf16* out;        // [n][h][w][cout]
  int h, w, cout, op, tiles, items;
  float slope;
};

// hand stage buffer s back to every CTA of the cluster (one arrival a
// consumer warpgroup, by its first thread)
__device__ __forceinline__ void release(uint64_t* empty, int s, bool leader) {
  if (leader)
    for (uint32_t r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(smem_u32(&empty[s]), r);
}

// grid: whole clusters, at most as many as are resident at once.  Item i
// (n, row, group of CLUSTER tiles) goes to cluster i mod clusters; CTA r of
// the cluster takes tile t = CLUSTER * group + r, columns [240 t, 240 t + 240) of the row
// (those inside the frame; a tile past the frame copies no activations and
// stores nothing).  Stage G of a CTA (13 a tile: 12 of the 3x3, then W2)
// lives in ring buffer G % STAGES.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NC + NP, 1)
    block128_tc_kernel_wgmma(const __grid_constant__ CUtensorMap xmap, const WgArgs A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* hid = ring + STAGES * STAGE_BYTES;  // [NG][TP][8], then [TP][OSTR]
  uint64_t* full = reinterpret_cast<uint64_t*>(hid + HID_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);  // the producer's expect_tx
      // one arrival per consumer warpgroup of the cluster: the weights are
      // written into every CTA of it
      mbar_init(smem_u32(&empty[s]), NC / 128 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no CTA copies into or arrives on another's barriers before they exist
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  const int groups = (A.tiles + CLUSTER - 1) / CLUSTER;  // of CLUSTER tiles a row

  if (threadIdx.x >= NC) {  // ---------------------------------------- producer
    if (threadIdx.x == NC) {
      prefetch_tensor_map(&xmap);
      const unsigned char* w1b = reinterpret_cast<const unsigned char*>(A.w1p);
      const unsigned char* w2b = reinterpret_cast<const unsigned char*>(A.w2p);
      const uint32_t w2_bytes = (uint32_t)A.op * NG * 16;
      int G = 0;
#pragma unroll 1
      for (int it = cluster; it < A.items; it += clusters) {
        const int n = it / (A.h * groups), row = it / groups % A.h;
        const int col0 = (it % groups * CLUSTER + (int)rank) * TP;
        const bool live = col0 < A.w;
#pragma unroll 1
        for (int g = 0; g < TILE_STAGES; ++g, ++G) {
          const int s = G % STAGES;
          const uint32_t st = smem_u32(ring + s * STAGE_BYTES), bar = smem_u32(&full[s]);
          if (G >= STAGES) mbar_wait(smem_u32(&empty[s]), (G / STAGES - 1) & 1);
          if (g < CONV_STAGES) {  // slice g / 3, dy = g % 3
            const int dy = g % 3, c0 = g / 3 * KC;
            mbar_arrive_tx(bar, WS_BYTES + (live ? KG * XP * 16 : 0));
            constexpr uint32_t half = WS_BYTES / CLUSTER;
            bulk_copy_multicast(st + rank * half, w1b + (size_t)g * WS_BYTES + rank * half, half,
                                bar, (1u << CLUSTER) - 1);
            if (live)
              for (int k = 0; k < KG; ++k)
                tensor_copy_4d(st + WS_BYTES + k * XPS * 16, &xmap, c0 + 8 * k, col0 - 1,
                               row + dy - 1, n, bar);
          } else {
            const uint32_t half = w2_bytes / CLUSTER;
            mbar_arrive_tx(bar, w2_bytes);
            bulk_copy_multicast(st + rank * half, w2b + rank * half, half, bar,
                                (1u << CLUSTER) - 1);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------------ consumers
    const int wg = threadIdx.x >> 7, v = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g4 = lane >> 2;
    const bool leader = (threadIdx.x & 127) == 0;
    const bool out_rows = 64 * wg < A.op;  // this warpgroup has output channels of the 1x1
    const uint32_t ring_u = smem_u32(ring), hid_u = smem_u32(hid);
    const bf16* hs = reinterpret_cast<const bf16*>(hid);
    // the epilogues store 8 x 8 blocks of the accumulators transposed, four
    // at a time: (hf, column block) = (0, j), (1, j), (0, j + 1), (1, j + 1);
    // the lane's block bi and row br
    const int bi = lane >> 3, br = lane & 7;
    // hidden tile: row br of block bi is pixel 8 (j + bi / 2) + br, channel
    // group 8 wg + 2 v + bi % 2
    const uint32_t hid_st = hid_u + ((8 * wg + 2 * v + (bi & 1)) * TP + 8 * (bi >> 1) + br) * 16;
    // output tile: the same pixel, output channels 64 wg + 16 v + 8 (bi % 2) ..
    const uint32_t out_st =
        hid_u + ((8 * (bi >> 1) + br) * OSTR + 64 * wg + 16 * v + 8 * (bi & 1)) * 2;
    float bias1[2], bias2[2];   // of rows 64 wg + 16 v + g4 + 8 hf
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = 64 * wg + 16 * v + g4 + 8 * hf;
      bias1[hf] = A.b1[m];
      bias2[hf] = m < A.cout ? A.b2[m] : 0.f;
    }
    float d[120];
    int G = 0;
#pragma unroll 1
    for (int it = cluster; it < A.items; it += clusters) {
      const int n = it / (A.h * groups), row = it / groups % A.h;
      const int col0 = (it % groups * CLUSTER + (int)rank) * TP;

      // ---- the 3x3: hidden channels 64 wg .. 64 wg + 63 x the tile's pixels
      int owed = -1;  // a buffer whose products are done but not yet handed back
#pragma unroll 1
      for (int g = 0; g < CONV_STAGES; ++g, ++G) {
        const int s = G % STAGES;
        mbar_wait(smem_u32(&full[s]), (G / STAGES) & 1);
        const uint32_t ws = ring_u + s * STAGE_BYTES, xs = ws + WS_BYTES;
        wg_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kk = 0; kk < KG / 2; ++kk)
            mma_64x240(d, wg_desc(ws + ((dx * KG + 2 * kk) * C + 64 * wg) * 16, C * 16, 128),
                       wg_desc(xs + (2 * kk * XPS + dx) * 16, XPS * 16, 128),
                       g > 0 || dx > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();
        if (owed >= 0) release(empty, owed, leader);
        owed = s;
      }
      wg_wait<0>();
      fence_operands(d);
      release(empty, owed, leader);

      // ---- epilogue 1: + b1, leaky, bf16 -> hidden tile [NG][TP][8]
      named_sync(kTile, NC);  // the previous tile's output tile has been stored
#pragma unroll
      for (int j = 0; j < TP / 8; j += 2) {
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * (j + (i >> 1)) + 2 * (i & 1);
          r[i] = bias_leaky_bf16x2(d[k], d[k + 1], bias1[i & 1], A.slope);
        }
        stsm_x4_trans(hid_st + j * 8 * 16, r);
      }
      fence_async_smem();
      named_sync(kTile, NC);

      // ---- the 1x1: output channels 64 wg .. 64 wg + 63 x the tile's pixels
      {
        const int s = G % STAGES;
        mbar_wait(smem_u32(&full[s]), (G / STAGES) & 1);
        if (out_rows) {
          const uint32_t w2s = ring_u + s * STAGE_BYTES;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < NG / 2; ++kk)
            mma_64x240(d, wg_desc(w2s + (2 * kk * A.op + 64 * wg) * 16, A.op * 16, 128),
                       wg_desc(hid_u + 2 * kk * TP * 16, TP * 16, 128), kk > 0);
          wg_commit();
          wg_wait<0>();
          fence_operands(d);
        }
        release(empty, s, leader);
        ++G;
      }
      named_sync(kTile, NC);  // every read of the hidden tile is done

      // ---- epilogue 2: + b2, leaky, bf16 -> output tile [TP][OSTR]
      if (out_rows) {
#pragma unroll
        for (int j = 0; j < TP / 8; j += 2) {
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * (j + (i >> 1)) + 2 * (i & 1);
            r[i] = bias_leaky_bf16x2(d[k], d[k + 1], bias2[i & 1], A.slope);
          }
          stsm_x4_trans(out_st + j * 8 * OSTR * 2, r);
        }
      }
      named_sync(kTile, NC);

      // ---- 16-byte stores of the columns inside the frame (channels-last)
      const int units = A.cout / 8;
      bf16* orow = A.out + ((size_t)(n * A.h + row) * A.w + col0) * A.cout;
      for (int u = threadIdx.x; u < TP * units; u += NC) {
        const int p = u / units, k = u % units;
        if (col0 + p < A.w)
          *reinterpret_cast<uint4*>(orow + (size_t)p * A.cout + 8 * k) =
              *reinterpret_cast<const uint4*>(hs + p * OSTR + 8 * k);
      }
    }
  }
  cluster_sync();  // no CTA exits while another may still copy into it or arrive on its barriers
}

// cuTensorMapEncodeTiled from the libcuda.so.1 the CUDA runtime has loaded
// (the library is not linked against it)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The tensor map of x [n][h][w][C] bf16 (dims innermost first: C, w, h, n):
// a box is 8 channels x XP columns of one row.
int x_map(CUtensorMap* map, const void* x, int n, int h, int w) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)w * C * 2,
                                 (cuuint64_t)h * w * C * 2};
  const cuuint32_t box[4] = {8, XP, 1, 1}, elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// clusters of the kernel resident at once on the current device (cached per
// device, as allow_smem)
int resident_clusters(int& out) {
  static int cached[32] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32 && cached[dev] > 0) {
    out = cached[dev];
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(NC + NP, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  int k = 0;
  e = cudaOccupancyMaxActiveClusters(&k, (const void*)block128_tc_kernel_wgmma, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (k <= 0) return (int)cudaErrorInvalidConfiguration;
  if (dev < 32) cached[dev] = k;
  out = k;
  return 0;
}

}  // namespace

extern "C" {

// x [n][h][w][128] bf16 channels-last, 16-byte aligned; w1p, w2p bf16 as
// packed (WgArgs); b1 [128], b2 [cout] float32; out [n][h][w][cout] bf16.
// cout % 8 == 0, cout <= 128.
int pcss_block128_wgmma(const void* x, const void* w1p, const void* b1, const void* w2p,
                        const void* b2, void* out, int n, int cout, int h, int w, float slope,
                        void* stream) {
  if (cout % 8 || cout <= 0 || cout > MAX_OP || n <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  int e = allow_smem((const void*)block128_tc_kernel_wgmma, SMEM, done);
  if (e) return e;
  CUtensorMap map;
  e = x_map(&map, x, n, h, w);
  if (e) return e;
  int most = 0;
  e = resident_clusters(most);
  if (e) return e;
  const int tiles = (w + TP - 1) / TP;
  const WgArgs A{(const bf16*)w1p, (const bf16*)w2p, (const float*)b1, (const float*)b2,
                 (bf16*)out, h, w, cout, cout <= 64 ? 64 : 128, tiles,
                 n * h * ((tiles + CLUSTER - 1) / CLUSTER), slope};
  const int clusters = A.items < most ? A.items : most;
  block128_tc_kernel_wgmma<<<clusters * CLUSTER, NC + NP, SMEM, (cudaStream_t)stream>>>(map, A);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// bytes of dynamic shared memory one block of the kernel takes
size_t pcss_block128_wgmma_smem_bytes() { return SMEM; }

}  // extern "C"
