// K7: a single int8 3x3 SAME conv on NHWC with a per-band dynamic activation
// scale (replaces pcss_unet_tpu/ops/pallas/conv3x3_int8.py::conv3x3_int8_nhwc,
// body _conv_kernel).
//
//   a   = max|band rows and one halo row above and below| / 127 + 1e-12
//         (halo rows outside the frame count as zero)
//   out = f32(int32 3x3 of quant(x, a) with wq) * (a * w_scales) + bias,
//         LeakyReLU if asked, stored as out_dtype
//
// It is the first half of K3 with its own epilogue, so it runs the same
// three launches (int8_conv.cuh): row maxima, the band copy (each input
// quantized once), then the 3x3 on warpgroup MMA (int8_taps_kernel_wgmma).
// The reference grids over output-channel tiles (pick_tiles); the band scale
// is the same in every tile, so co_tile only groups the blocks' 256-channel
// tiles and each block takes the scale from the shared row maxima.
//
// What bounds it on the H100: at the w64 dec_1a shape (x [1,272,480,512],
// Co 512) 308 G int8 multiply-adds, 0.31 ms at the 1979 TOP/s int8
// tensor-core rate, against ~0.27 GB moved (~0.08 ms; the band copy at
// pick_tiles' 2-row bands adds 141 MB written and read again): operations.
// No model path calls it: the reference measured it and kept it out of the
// model.
#include "int8_conv.cuh"

namespace {

template <typename T>
int launch_out(const void* x, const void* wp, const void* ws, const void* bias, void* out,
               void* rowmax, void* xq, int n, int h, int w, int c, int co, int k_rows, int co_tile,
               float slope, int apply_leaky, int out_bf16, cudaStream_t stream) {
  if (out_bf16)
    return launch_conv3x3_int8<T, __nv_bfloat16, false>(x, wp, ws, bias, rowmax, nullptr, xq,
                                                        out, n, h, w, c, c, co, co_tile, k_rows,
                                                        slope, apply_leaky, stream);
  return launch_conv3x3_int8<T, float, false>(x, wp, ws, bias, rowmax, nullptr, xq, out, n, h, w,
                                              c, c, co, co_tile, k_rows, slope, apply_leaky,
                                              stream);
}

}  // namespace

extern "C" {

// x [n,h,w,c] bf16 or float32; wp int8 [9][c/16][co][16]; ws/bias [co]
// float32; out [n,h,w,co] bf16 or float32.  Scratch: rowmax float32 [n*h],
// xq int8, the band copy (int8_conv.cuh) with one chunk.  x and xq 16-byte
// aligned.
int pcss_conv3x3_int8_nhwc(const void* x, const void* wp, const void* ws, const void* bias,
                           void* out, void* rowmax, void* xq, int n, int h, int w, int c, int co,
                           int k_rows, int co_tile, float slope, int apply_leaky, int is_bf16,
                           int out_bf16, void* stream) {
  if (c % 16 || k_rows < 1 || h % k_rows || co_tile < 1 || co % co_tile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_out<__nv_bfloat16>(x, wp, ws, bias, out, rowmax, xq, n, h, w, c, co, k_rows,
                                     co_tile, slope, apply_leaky, out_bf16, s);
  return launch_out<float>(x, wp, ws, bias, out, rowmax, xq, n, h, w, c, co, k_rows, co_tile,
                           slope, apply_leaky, out_bf16, s);
}

}  // extern "C"
