// K3 and K5: a whole folded ConvBlock in int8 on NHWC (replace
// pcss_unet_tpu/ops/pallas/block_int8.py::fused_block_int8_nhwc, body
// _kernel, and ::fused_block_int8_kchunked, body _kchunk_kernel).
//
// Per band of k_rows rows:
//   a1_j = max|band rows and one halo row above and below, channels of chunk j|
//          / 127 + 1e-12   (halo rows outside the frame count as zero)
//   f = sum over chunks j, in order, of f32(int32 3x3 of quant(x_j, a1_j)) * (a1_j * s1)
//   h = leaky(f + b1)            K3: one chunk (all C), h rounded to bf16
//                                K5: C / c_chunk chunks, h kept in float32
//   a2 = max|h over the band| / 127 + 1e-12
//   out = leaky(int8 1x1 of quant(h, a2) * (a2 * s2) + b2), stored in x's dtype
// quant(v, s) = clip(rint(v / s), -127, 127) with true division.  The two
// kernels differ only in the chunking and in h's type: K3 casts h to bf16
// before a2, K5 does not, as in the reference.
//
// Both scales reduce over a whole band, and blocks run in no order, so the
// block is four launches on one stream (all in int8_conv.cuh):
//   1. rowmax_kernel: max|x| of every (row, chunk), and zero the per-band max |h|;
//   2. rowmax_kernel_quant_bands: x quantized once by its band's scales into
//      the band copy, int8 in the layout the 3x3's stages read;
//   3. int8_taps_kernel_wgmma: the 3x3 on warpgroup MMA, 126 pixels x 256
//      channels a block in clusters of two that share the weights, a ring of
//      6 stages (3 for K5) filled by bulk copies (the weights multicast, the
//      activations from the band copy), chunks folded in order so the float32
//      sum order is fixed, h into a scratch tensor, per-band max |h|;
//   4. int8_taps_kernel: quantize h by a2, the 1x1 on mma.sync (128 x 128
//      a block), dequantize, bias, leaky, store.
//
// What bounds them on the H100: at w16 dec_0 (K3, x [1,128,256,256], Cmid
// 256, Cout 128) 20.4 G int8 multiply-adds, at w64 dec_1 (K3, x
// [1,272,480,512], Cmid 512, Cout 128) 317 G, at w64 dec_0 (K5, x
// [1,136,240,1024], Cmid 1024, Cout 512) 325 G: operations (0.02 / 0.32 /
// 0.33 ms at the 1979 TOP/s int8 tensor-core rate) far above the bytes (~25
// / ~170 / ~110 MB).  The 3x3 is 90-95 % of the operations, so it is the
// stage on wgmma (int8_conv.cuh says what bounds its loop); the 1x1 stayed
// on mma.sync.  Both keep every integer sum exact and every float32 step in
// the plain version's order, so the results equal the plain versions bit
// for bit.  Until the band copy, the 3x3's producers quantized every input
// row again for each dy and each 256-channel tile (6 times at w64 dec_1, 12
// at dec_0) and bound the stage at ~20 % of its int8 rate; the copy costs
// one pass over x and (k_rows + 2) / k_rows x its elements in int8 (141 MB
// at w64 dec_1, 71 MB at dec_0: both in bands of 2 rows).  The h scratch
// round trip adds 2 x 134 MB (K3 at w64 dec_1, bf16 h) and 2 x 134 MB (K5,
// float32 h).
#include "int8_conv.cuh"

namespace {

template <typename T, typename HT>
int launch(const void* x, const void* w1p, const void* s1, const void* b1, const void* w2p,
           const void* s2, const void* b2, void* out, void* rowmax, void* bandmax, void* xq,
           void* hbuf, int n, int h, int w, int c, int c_chunk, int cmid, int cout, int k_rows,
           float slope, cudaStream_t stream) {
  int e = launch_conv3x3_int8<T, HT, true>(x, w1p, s1, b1, rowmax, bandmax, xq, hbuf, n, h, w,
                                           c, c_chunk, cmid, cmid, k_rows, slope, 1, stream);
  if (e) return e;
  const I8Args A{hbuf, nullptr, (const int4*)w2p, (const float*)s2, (const float*)b2, nullptr,
                 (const unsigned*)bandmax, nullptr, out, h, w, cmid, cmid, cout, cout, k_rows,
                 1, slope};
  return launch_pointwise<HT, T>(A, n, stream);
}

}  // namespace

extern "C" {

// x [n,h,w,c] bf16 or float32; w1p int8 [9][c/16][cmid][16]; w2p int8
// [cmid/16][cout][16]; s1/b1 [cmid], s2/b2 [cout] float32.  K3: c_chunk = c,
// hbuf bf16; K5: c_chunk < c, hbuf float32 (hidden_f32).  Scratch: rowmax
// float32 [n*h*(c/c_chunk)], bandmax uint32 [n*h/k_rows], xq int8 [n][h /
// k_rows][k_rows + 2][band_words][band_cols][16] (the band copy,
// int8_conv.cuh), hbuf [n,h,w,cmid].  x, xq and hbuf 16-byte aligned.
int pcss_block_int8_nhwc(const void* x, const void* w1p, const void* s1, const void* b1,
                         const void* w2p, const void* s2, const void* b2, void* out,
                         void* rowmax, void* bandmax, void* xq, void* hbuf, int n, int h, int w,
                         int c, int c_chunk, int cmid, int cout, int k_rows, float slope,
                         int is_bf16, int hidden_f32, void* stream) {
  if (c % 16 || cmid % 16 || c_chunk < 16 || c_chunk % 16 || c % c_chunk || k_rows < 1 ||
      h % k_rows || cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && hidden_f32)
    return launch<__nv_bfloat16, float>(x, w1p, s1, b1, w2p, s2, b2, out, rowmax, bandmax, xq,
                                        hbuf, n, h, w, c, c_chunk, cmid, cout, k_rows, slope, s);
  if (is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w1p, s1, b1, w2p, s2, b2, out, rowmax,
                                                bandmax, xq, hbuf, n, h, w, c, c_chunk, cmid,
                                                cout, k_rows, slope, s);
  if (hidden_f32)
    return launch<float, float>(x, w1p, s1, b1, w2p, s2, b2, out, rowmax, bandmax, xq, hbuf, n,
                                h, w, c, c_chunk, cmid, cout, k_rows, slope, s);
  return launch<float, __nv_bfloat16>(x, w1p, s1, b1, w2p, s2, b2, out, rowmax, bandmax, xq,
                                      hbuf, n, h, w, c, c_chunk, cmid, cout, k_rows, slope, s);
}

// The first two launches alone: x's band copy into xq (rowmax as above),
// for tests.
int pcss_quant_bands(const void* x, void* rowmax, void* xq, int n, int h, int w, int c,
                     int c_chunk, int k_rows, int is_bf16, void* stream) {
  if (c % 16 || c_chunk < 16 || c_chunk % 16 || c % c_chunk || k_rows < 1 || h % k_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_quant_bands<__nv_bfloat16>(x, rowmax, nullptr, xq, n, h, w, c, c_chunk, k_rows,
                                             s);
  return launch_quant_bands<float>(x, rowmax, nullptr, xq, n, h, w, c, c_chunk, k_rows, s);
}

// Dynamic shared memory of one int8 kernel block: the 3x3
// (int8_taps_kernel_wgmma, taps 9) with `nchunks` contraction chunks, or the
// 1x1 (int8_taps_kernel, taps 1), for reports.
size_t pcss_int8_smem_bytes(int taps, int nchunks) {
  if (taps != 9) return pointwise_smem_bytes();
  return nchunks > 1 ? wg_smem_bytes<true>(nchunks) : wg_smem_bytes<false>(nchunks);
}

}  // extern "C"
