// K2: whole folded ConvBlock, channels-major (replaces
// pcss_unet_tpu/ops/pallas/convblock.py::fused_conv_block_chw and its bodies
// _convblock_kernel / _rowpack_kernel).
//
//   out = leaky(W2 · cast(leaky(conv3x3_SAME(x, W1) + b1)) + b2)
//   then + residual (float32), then columns >= true_w set to zero, then cast.
//
// out [N, Cout, H, Wp] (Wp % 128 == 0), bf16 or float32.  x is the block's
// input of Hx <= H rows and Wx <= Wp columns; rows outside [0, Hx) and
// columns outside [0, Wx) read as zero (SAME padding, and the pad columns of
// the output tiles).  K2 hands in x [N, Cin, H, Wp] itself (Hx = H, Wx = Wp,
// pad columns zero by contract); K2' its NHWC input as it lies in memory
// where that storage is dense.
// The hidden value is rounded to the storage dtype before the 1x1, as the
// reference does; every sum accumulates in float32.  Cin, Cmid, Cout <= 128
// and Cmid, Cout % 4 == 0 (the C entry refuses anything else).  The entry
// dispatches on the dtype; neither path falls back to the other.
//
// bf16: convblock_chw_tc_kernel, an implicit GEMM on the tensor cores
// (mma.sync m16n8k16 bf16 -> float32, fragments by ldmatrix; the helpers and
// the transposing stage live in bf16_mma.cuh, shared with K6).  What bounds it
// on the H100: the w64 chw stages do ~116 G multiply-adds against ~0.4 GB
// moved, so the work is bound by operations (bf16 tensor-core peak 989
// TFLOP/s, bound ~0.26 ms); the w16 stages (~28 G, 16-32 channels) are
// closer to their bytes, and there staging and the launch dominate.  Design:
// - one block (8 warps) per (n, row, 128-column tile): GEMM M = 128 pixels,
//   N = Cmid (all of it, so the hidden tile never leaves the chip), K = 9 taps
//   x Cin in slices of 16;
// - the rows r-1..r+1 are staged once, pixel-major [3][130][Cin16 + 8] bf16,
//   from the storage x has (bf16_mma.cuh, enum Stage, picked by the wrapper
//   from x's strides): dense channels-major, 16-byte reads along W of 8
//   channels transposed in registers (prmt) into one 16-byte store per pixel
//   (K2's padded input, K2' enc_1's pooled input); dense channels-last, one
//   16-byte cp.async of 8 channels straight into place (K2' enc_0 and
//   dec_final).  K2' copies any other storage first.  An A fragment row is
//   then one pixel's 8 consecutive channels, 16-byte aligned for every tap
//   offset dx; the 8 extra channels of stride put the 8 rows of an ldmatrix
//   in distinct banks.  Channels Cin..Cin16 are staged as zeros;
// - the weights are used as given (w1 [9][Cmid][Cin], w2 [Cout][Cmid]: the
//   K-contiguous B layout of mma .row.col).  One tap's [Cmid][Cin] slice is
//   copied by cp.async into one of two buffers while the tensor cores work
//   on the other; w2 arrives during the last tap.  Pad rows and columns of
//   the buffers are zeroed once when a channel count is not a multiple of 16;
// - warp tile 32 pixels x 64 channels (4 x 2 warps) when N > 64, else
//   16 pixels x N (8 x 1), so no warp idles at the 16- to 64-channel stages;
// - epilogue 1 in registers (+b1, leaky, round to bf16) into a pixel-major
//   hidden tile [128][Cmid16 + 8] that replaces the x stage in shared memory;
//   the 1x1 is a second mma.sync loop over K = Cmid from it against w2;
// - epilogue 2: +b2, leaky into a float32 [Cout][128 + 4] tile, then 16-byte
//   accesses along W: + residual (float32), columns >= true_w zeroed, bf16.
// Shared memory is at most 206 KB (Cin = Cmid = Cout = 128), so one block per
// SM at the widest stage.  Left for later work: wgmma with TMA-fed swizzled
// tiles (the only way to the full tensor-core rate), a persistent grid whose
// next tile's staging overlaps this tile's epilogue, and overlap of the x
// stage itself with the first taps.
//
// float32: convblock_chw_kernel on the CUDA cores, dense x [N, Cin, H, Wp] only
// (tensor cores would mean TF32, which the float32 tolerance of 1e-4 does not
// allow).  One block per
// (n, row, 128-column tile); the input rows are staged in shared memory 16
// channels at a time; each warp owns 4-wide groups of hidden channels for 64
// of the 128 pixels (2 per lane), keeps their float32 sums in registers and
// reads each weight float4 once per (tap, input channel) as a warp-uniform
// broadcast.  The hidden tile [Cmid][128] stays in shared memory and
// feeds the 1x1 the same way.  It takes transposed float32 weights (w1t
// [9][Cin][Cmid], w2t [Cmid][Cout]).
#include "bf16_mma.cuh"
#include "common.cuh"

namespace {

constexpr int TW = 128;       // output columns per block
constexpr int XW = TW + 2;    // staged columns (one halo column each side)
constexpr int CC = 16;        // input channels staged per step
constexpr int NT = 256;       // threads per block: 8 warps
constexpr int SLOTS = 8;      // 4-channel groups per warp: 8 slots * 4 warps-per-half * 4 = 128

__global__ void __launch_bounds__(NT)
convblock_chw_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                     const float* __restrict__ b1, const float* __restrict__ w2t,
                     const float* __restrict__ b2, const float* __restrict__ residual,
                     float* __restrict__ out, int cin, int cmid, int cout, int h, int wp,
                     int true_w, float slope) {
  extern __shared__ float smem[];
  float* xs = smem;               // [CC][3][XW]
  float* hs = smem + CC * 3 * XW; // [cmid][TW]
  const int col0 = blockIdx.x * TW;
  const int row = blockIdx.y;
  const int n = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w works on pixels half*64 + lane + 32*j (j = 0, 1) and on channel
  // groups g = (w >> 1) + 4*s for slots s = 0..SLOTS-1
  const int half = warp & 1, gbase = warp >> 1;
  const int p0 = half * 64 + lane;
  const size_t plane = (size_t)h * wp;
  const float* xn = x + (size_t)n * cin * plane;

  // ---- 3x3 conv into float32 registers ----
  float acc[SLOTS][4][2];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[s][k][0] = acc[s][k][1] = 0.f;

  const int ngroups = cmid / 4;
  for (int c0 = 0; c0 < cin; c0 += CC) {
    const int cc = min(CC, cin - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cc * 3 * XW; i += NT) {
      const int col = i % XW, r = (i / XW) % 3, ci = i / (3 * XW);
      const int gr = row + r - 1, gc = col0 + col - 1;
      float v = 0.f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < wp)
        v = xn[(size_t)(c0 + ci) * plane + (size_t)gr * wp + gc];
      xs[i] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < cc; ++ci) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3, dx = t % 3;  // tap dy*3 + dx, as w1 [9, Cmid, Cin]
        const float* xr = xs + (ci * 3 + dy) * XW + dx;
        const float xv0 = xr[p0], xv1 = xr[p0 + 32];
        const float* wrow = w1t + ((size_t)t * cin + c0 + ci) * cmid;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int g = gbase + 4 * s;
          if (g < ngroups) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(wrow) + g);
            acc[s][0][0] = fmaf(wv.x, xv0, acc[s][0][0]);
            acc[s][0][1] = fmaf(wv.x, xv1, acc[s][0][1]);
            acc[s][1][0] = fmaf(wv.y, xv0, acc[s][1][0]);
            acc[s][1][1] = fmaf(wv.y, xv1, acc[s][1][1]);
            acc[s][2][0] = fmaf(wv.z, xv0, acc[s][2][0]);
            acc[s][2][1] = fmaf(wv.z, xv1, acc[s][2][1]);
            acc[s][3][0] = fmaf(wv.w, xv0, acc[s][3][0]);
            acc[s][3][1] = fmaf(wv.w, xv1, acc[s][3][1]);
          }
        }
      }
    }
  }

  // ---- bias, leaky: hidden tile in smem ----
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int g = gbase + 4 * s;
    if (g < ngroups) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = 4 * g + k;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          hs[m * TW + p0 + 32 * j] = leaky(__fadd_rn(acc[s][k][j], b1[m]), slope);
        }
      }
    }
  }
  __syncthreads();

  // ---- 1x1 conv from the hidden tile ----
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[s][k][0] = acc[s][k][1] = 0.f;
  const int ogroups = cout / 4;
  for (int m = 0; m < cmid; ++m) {
    const float hv0 = hs[m * TW + p0], hv1 = hs[m * TW + p0 + 32];
    const float* wrow = w2t + (size_t)m * cout;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int g = gbase + 4 * s;
      if (g < ogroups) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wrow) + g);
        acc[s][0][0] = fmaf(wv.x, hv0, acc[s][0][0]);
        acc[s][0][1] = fmaf(wv.x, hv1, acc[s][0][1]);
        acc[s][1][0] = fmaf(wv.y, hv0, acc[s][1][0]);
        acc[s][1][1] = fmaf(wv.y, hv1, acc[s][1][1]);
        acc[s][2][0] = fmaf(wv.z, hv0, acc[s][2][0]);
        acc[s][2][1] = fmaf(wv.z, hv1, acc[s][2][1]);
        acc[s][3][0] = fmaf(wv.w, hv0, acc[s][3][0]);
        acc[s][3][1] = fmaf(wv.w, hv1, acc[s][3][1]);
      }
    }
  }

  // ---- epilogue: bias, leaky, + residual, pad columns to zero, store ----
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int g = gbase + 4 * s;
    if (g < ogroups) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = 4 * g + k;
        const size_t base = (((size_t)n * cout + o) * h + row) * wp + col0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = p0 + 32 * j;
          float v = leaky(__fadd_rn(acc[s][k][j], b2[o]), slope);
          if (residual != nullptr) v = __fadd_rn(v, residual[base + p]);
          if (col0 + p >= true_w) v = 0.f;
          out[base + p] = v;
        }
      }
    }
  }
}

size_t f32_smem(int cmid) { return sizeof(float) * ((size_t)CC * 3 * XW + (size_t)cmid * TW); }

int launch_f32(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
               const void* residual, void* out, int n, int cin, int cmid, int cout, int h,
               int wp, int true_w, float slope, cudaStream_t stream) {
  static unsigned done = 0;
  const int e = allow_smem((const void*)convblock_chw_kernel, f32_smem(128), done);
  if (e) return e;
  const dim3 grid(wp / TW, h, n);
  convblock_chw_kernel<<<grid, NT, f32_smem(cmid), stream>>>(
      (const float*)x, (const float*)w1t, (const float*)b1, (const float*)w2t,
      (const float*)b2, (const float*)residual, (float*)out, cin, cmid, cout, h, wp, true_w,
      slope);
  PCSS_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------- bf16 path

using namespace tc;  // the bf16 mma helpers (bf16_mma.cuh)
static_assert(NT == kThreads && TW == kTile && XW == kStageW, "bf16_mma.cuh tile");
constexpr int OS = TW + 4;  // row stride of the float32 output tile (528-byte rows)

// x as the bf16 kernel reads it: dense [N][Cin][h][w] (stage kCmajorVec, w
// % 8 == 0) or dense [N][h][w][Cin] (kNhwc, Cin % 8 == 0), 16-byte aligned.
struct XView {
  int stage, h, w;
};

// Shared-memory plan of the bf16 kernel (bytes), shared by host and device.
// Channel counts are padded to 16 (kp, mp, op); cs and hs are the row strides
// (bf16) of the x stage / w1 slices and of the hidden tile / w2.  Region 0
// holds the x stage [3][XW][cs], later the hidden tile [TW][hs] followed by
// the float32 output tile [op][OS]; then two w1 slices [mp][cs] and w2 [op][hs].
struct TcPlan {
  int kp, mp, op, cs, hs;
  size_t region0, bytes;
};

__host__ __device__ __forceinline__ TcPlan tc_plan(int cin, int cmid, int cout) {
  TcPlan p;
  p.kp = (cin + 15) & ~15;
  p.mp = (cmid + 15) & ~15;
  p.op = (cout + 15) & ~15;
  p.cs = p.kp + 8;
  p.hs = p.mp + 8;
  const size_t stage = (size_t)3 * XW * p.cs * 2;
  const size_t tiles = (size_t)TW * p.hs * 2 + (size_t)p.op * OS * 4;
  p.region0 = stage > tiles ? stage : tiles;
  p.bytes = p.region0 + (size_t)2 * p.mp * p.cs * 2 + (size_t)p.op * p.hs * 2;
  return p;
}

__global__ void __launch_bounds__(NT, 1)
convblock_chw_tc_kernel(const bf16* __restrict__ x, const XView X, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const bf16* __restrict__ residual,
                        bf16* __restrict__ out, int cin, int cmid, int cout, int h, int wp,
                        int true_w, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcPlan P = tc_plan(cin, cmid, cout);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                       // [3][XW][cs]
  bf16* hid = xs;                                                     // [TW][hs]
  float* os = reinterpret_cast<float*>(smem_raw + (size_t)TW * P.hs * 2);  // [op][OS]
  bf16* w1s = reinterpret_cast<bf16*>(smem_raw + P.region0);          // 2 x [mp][cs]
  bf16* w2s = w1s + 2 * P.mp * P.cs;                                  // [op][hs]

  const int col0 = blockIdx.x * TW, row = blockIdx.y, n = blockIdx.z;

  // pad rows / columns of the weight buffers stay zero: no load writes them
  if ((cin | cmid | cout) & 15) {
    uint4* z = reinterpret_cast<uint4*>(w1s);
    const int nz = (2 * P.mp * P.cs + P.op * P.hs) / 8;
    for (int i = threadIdx.x; i < nz; i += NT) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  load_matrix(w1s, P.cs, w1, cmid, cin);  // tap 0
  cp_async_commit();

  const size_t plane = (size_t)X.h * X.w;
  const bf16* xn = x + (size_t)n * cin * plane;
  if (X.stage == kNhwc)  // cp.async, waited with tap 0's weights
    stage_rows_nhwc(xs, P.cs, P.kp, xn, cin, X.h, X.w, row, col0, (size_t)X.w * cin, cin);
  else
    stage_rows(xs, P.cs, P.kp, xn, cin, X.h, X.w, row, col0, plane, X.w);
  cp_async_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int a_row = lane & 15, a_k = (lane >> 4) << 3;                 // A ldmatrix rows
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) << 3;
  float acc[2][8][4];

  // ---- 3x3: nine taps, w1 slice t+1 (then w2) in flight during tap t ----
  bool two = P.mp > 64;
  int pm = two ? (warp & 3) * 32 : warp * 16, nb0 = two ? (warp >> 2) * 64 : 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][nj][k] = 0.f;
  for (int t = 0; t < 9; ++t) {
    cp_async_wait_all();
    __syncthreads();
    if (t < 8)
      load_matrix(w1s + ((t + 1) & 1) * P.mp * P.cs, P.cs, w1 + (size_t)(t + 1) * cmid * cin,
                  cmid, cin);
    else
      load_matrix(w2s, P.hs, w2, cout, cmid);
    cp_async_commit();
    const bf16* a = xs + (size_t)((t / 3) * XW + (t % 3) + pm + a_row) * P.cs + a_k;
    const bf16* b = w1s + (t & 1) * P.mp * P.cs + b_row * P.cs + b_k;
    mma_tile(acc, a, P.cs, b, P.cs, P.kp, nb0, P.mp, two);
  }
  __syncthreads();  // the hidden tile replaces the x stage

  // ---- epilogue 1: + b1, leaky, round to bf16 -> hidden tile [px][ch] ----
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (mi == 1 && !two) break;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int m = nb0 + nj * 8 + 2 * q;  // cmid % 4 == 0: m < cmid <=> m + 1 < cmid
      if (nb0 + nj * 8 < P.mp) {
        const bool real = m < cmid;
        const float c0 = real ? b1[m] : 0.f, c1 = real ? b1[m + 1] : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = pm + mi * 16 + g + hf * 8;
          const float v0 = real ? leaky(__fadd_rn(acc[mi][nj][2 * hf], c0), slope) : 0.f;
          const float v1 = real ? leaky(__fadd_rn(acc[mi][nj][2 * hf + 1], c1), slope) : 0.f;
          *reinterpret_cast<uint32_t*>(hid + p * P.hs + m) = pack_bf16x2(v0, v1);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- 1x1 from the hidden tile ----
  two = P.op > 64;
  pm = two ? (warp & 3) * 32 : warp * 16;
  nb0 = two ? (warp >> 2) * 64 : 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][nj][k] = 0.f;
  mma_tile(acc, hid + (pm + a_row) * P.hs + a_k, P.hs, w2s + b_row * P.hs + b_k, P.hs, P.mp,
           nb0, P.op, two);

  // ---- epilogue 2: + b2, leaky -> float32 tile [ch][px] ----
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (mi == 1 && !two) break;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int o = nb0 + nj * 8 + 2 * q;  // cout % 4 == 0, as above
      if (nb0 + nj * 8 < P.op && o < cout) {
        const float c0 = b2[o], c1 = b2[o + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = pm + mi * 16 + g + hf * 8;
          os[o * OS + p] = leaky(__fadd_rn(acc[mi][nj][2 * hf], c0), slope);
          os[(o + 1) * OS + p] = leaky(__fadd_rn(acc[mi][nj][2 * hf + 1], c1), slope);
        }
      }
    }
  }
  __syncthreads();

  // ---- + residual, pad columns to zero, bf16: 8 pixels of one channel a unit ----
  for (int u = threadIdx.x; u < cout * 16; u += NT) {
    const int o = u >> 4, pg = u & 15;
    const float4 lo = *reinterpret_cast<const float4*>(os + o * OS + pg * 8);
    const float4 hi = *reinterpret_cast<const float4*>(os + o * OS + pg * 8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t base = (((size_t)n * cout + o) * h + row) * wp + col0 + pg * 8;
    if (residual != nullptr) {
      const uint4 rq = *reinterpret_cast<const uint4*>(residual + base);
      const uint32_t rw[4] = {rq.x, rq.y, rq.z, rq.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // bf16 -> float32 is exact: the bits, shifted
        v[2 * k] = __fadd_rn(v[2 * k], __uint_as_float(rw[k] << 16));
        v[2 * k + 1] = __fadd_rn(v[2 * k + 1], __uint_as_float(rw[k] & 0xffff0000u));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col0 + pg * 8 + i >= true_w) v[i] = 0.f;
    *reinterpret_cast<uint4*>(out + base) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  }
}

int launch_tc(const void* x, const XView& X, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* residual, void* out, int n, int cin, int cmid,
              int cout, int h, int wp, int true_w, float slope, cudaStream_t stream) {
  static unsigned done = 0;
  const int e = allow_smem((const void*)convblock_chw_tc_kernel, tc_plan(128, 128, 128).bytes,
                           done);
  if (e) return e;
  const dim3 grid(wp / TW, h, n);
  convblock_chw_tc_kernel<<<grid, NT, tc_plan(cin, cmid, cout).bytes, stream>>>(
      (const bf16*)x, X, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
      (const bf16*)residual, (bf16*)out, cin, cmid, cout, h, wp, true_w, slope);
  PCSS_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// Dispatch by dtype; b1/b2 float32; residual may be null; true_w = Wp
// disables the column mask.  out [N][Cout][H][Wp]; x has xh <= H rows and
// xw <= Wp columns, dense in the storage `stage` names (enum Stage: kNhwc or
// kCmajorVec).  Device pointers 16-byte aligned.
//   bf16 (is_bf16 = 1): tensor-core kernel; w1 [9][Cmid][Cin] and w2
//     [Cout][Cmid] bf16 as packed (tap dy*3+dx);
//   float32: CUDA-core kernel on dense x [N][Cin][H][Wp] only; w1 = w1t
//     [9][Cin][Cmid], w2 = w2t [Cmid][Cout] float32.
int pcss_convblock_chw(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* residual, void* out, int n, int cin,
                       int cmid, int cout, int h, int wp, int true_w, float slope, int is_bf16,
                       int stage, int xh, int xw, void* stream) {
  if (cin > 128 || cmid > 128 || cout > 128 || cmid % 4 || cout % 4 || wp % TW)
    return (int)cudaErrorInvalidValue;
  if ((stage != kNhwc && stage != kCmajorVec) || xh > h || xw > wp ||
      (stage == kNhwc && cin % 8) || (stage == kCmajorVec && xw % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_tc(x, XView{stage, xh, xw}, w1, b1, w2, b2, residual, out, n, cin, cmid, cout,
                     h, wp, true_w, slope, s);
  if (stage != kCmajorVec || xh != h || xw != wp) return (int)cudaErrorInvalidValue;
  return launch_f32(x, w1, b1, w2, b2, residual, out, n, cin, cmid, cout, h, wp, true_w, slope,
                    s);
}

}  // extern "C"
