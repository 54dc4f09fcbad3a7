// The 3x3 SAME tap contraction shared by the NHWC row-band kernels
// (counterpart of pcss_unet_tpu/ops/pallas/taps.py::conv3x3_band_taps and of
// its plain version pcss_unet_tpu_torch/ops/kernels/taps.py).
//
// One output row of PX consecutive pixels reads a shared-memory tile
//   ext [3][PX + 2][C]   int8, C % 16 == 0
// ext row dy is input row r + dy - 1 (the band row and one halo row above and
// below); ext column j is input column p0 + j - 1.  The caller stages zeros
// outside the frame, which is exactly SAME padding.
//
// Tap t = dy*3 + dx + 1 with dy in {0,1,2} (ext row) and dx in {-1,0,1}: the
// order of an HWIO kernel reshaped to [9, C, Co], as the reference uses.
// The int8 kernels (whole block, k-chunked block, single conv) use it; the
// bf16 block kernels keep the same tap order in their own float loops.
#pragma once

#include "common.cuh"

// acc[p] += sum over taps and the input-channel words [k0, k1) of ext * w for
// one output channel, int8 x int8 -> int32 with __dp4a on 16-channel int4
// words.  [k0, k1) is the whole channel range or one contraction chunk.
//   ext    the tile above, as int4 words: [3][PX + 2][cw16]
//   wtap   this output channel's weights: word (t, k) at wtap[(t*cw16 + k)*wstride]
template <int PX>
__device__ __forceinline__ void conv3x3_band_taps_i8(const int4* ext, int cw16, int k0, int k1,
                                                     const int4* __restrict__ wtap,
                                                     int wstride, int (&acc)[PX]) {
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3, dxp1 = t % 3;  // dxp1 = dx + 1
    const int4* xrow = ext + (dy * (PX + 2) + dxp1) * cw16;
#pragma unroll 1
    for (int k = k0; k < k1; ++k) {
      const int4 wv = __ldg(wtap + (size_t)(t * cw16 + k) * wstride);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int4 xv = xrow[p * cw16 + k];
        acc[p] = __dp4a(xv.x, wv.x, acc[p]);
        acc[p] = __dp4a(xv.y, wv.y, acc[p]);
        acc[p] = __dp4a(xv.z, wv.z, acc[p]);
        acc[p] = __dp4a(xv.w, wv.w, acc[p]);
      }
    }
  }
}
