// Fused appearance-flow warp + mask composite + in-bounds validity.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _fwd_composite_kernel (called through _call_fwd_composite), the forward of
// flow_warp_composite on the model's flow-synthesis path.
//
// Per output pixel p of image n, with pixel coordinates (ix, iy):
//   valid     = 0 <= ix <= W-1 and 0 <= iy <= H-1   (unclamped coordinates)
//   border:     clamp (ix, iy) to the image, then sample bilinearly
//   zeros:      taps outside the image get weight 0
//   warped[c] = bilinear sample of channel c
//   view[c]   = mask * warped[c] + (1 - mask) * rgb[c]
// The taps, weights and rounding are bilinear.cuh's (shared with the
// backward and the multi-source kernels): the result is bitwise that of the
// plain PyTorch version in kernels/grid_sample.py, which does the same
// operations one by one.
//
// Bound on an H100 SXM: memory. At the c2 serving shape (N = 128 images of
// 3 x 128 x 128, P = 16,384 pixels each, 2.10 M pixels) every pixel moves
// 16 f32 values — ix, iy, mask, 3 rgb, 3 source taps (the image read once),
// 3 view, 3 warped, 1 valid — 64 B/pixel, 134 MB in all: about 40 us at
// 3.35 TB/s. The arithmetic (~40 flops/pixel) is two orders below the f32
// rate.
//
// Design: one thread per output pixel, looping over the channels. Threads
// of a block cover consecutive pixels of one image, so the reads of ix, iy,
// mask and each rgb plane and the writes of each output plane are
// coalesced. The four taps per channel are gathers from one image, which
// stays in L1/L2 (196 KB per image at c2). No shared memory, no atomics:
// every output is written once by one thread, so the result is
// deterministic.

#include "bilinear.cuh"

namespace {

using dmv3d::Taps;
using dmv3d::dot2;

constexpr int kThreads = 256;

template <bool kBorder, bool kFast>
__global__ void __launch_bounds__(kThreads) warp_composite_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ mask,
    const float* __restrict__ rgb, float* __restrict__ view,
    float* __restrict__ warped, float* __restrict__ valid, int c, int h,
    int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const float x = __ldg(ix + pix);
  const float y = __ldg(iy + pix);
  const float m = __ldg(mask + pix);
  valid[pix] = dmv3d::in_bounds(x, y, static_cast<float>(w - 1),
                                static_cast<float>(h - 1));
  const Taps<kBorder, kFast> taps(x, y, h, w);
  const float one_m = __fsub_rn(1.f, m);
  const int64_t plane = static_cast<int64_t>(h) * w;

  for (int ch = 0; ch < c; ++ch) {
    float v[4];
    taps.load(img + (b * c + ch) * plane, v);
    const float s = taps.lerp(taps.col0(v), taps.col1(v));
    const int64_t o = (b * c + ch) * p + q;
    warped[o] = s;
    view[o] = dot2(m, s, one_m, __ldg(rgb + o));
  }
}

template <bool kBorder, bool kFast>
void launch(const float* img, const float* ix, const float* iy,
            const float* mask, const float* rgb, float* view, float* warped,
            float* valid, int n, int c, int h, int w, int p,
            cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  warp_composite_fwd_kernel<kBorder, kFast><<<grid, kThreads, 0, stream>>>(
      img, ix, iy, mask, rgb, view, warped, valid, c, h, w, p);
}

}  // namespace

// img [n, c, h, w]; ix, iy, mask, valid [n, p]; rgb, view, warped [n, c, p];
// all f32, contiguous, on the device of `stream`. Returns cudaGetLastError().
extern "C" int dmv3d_warp_composite_fwd(const float* img, const float* ix,
                                        const float* iy, const float* mask,
                                        const float* rgb, float* view,
                                        float* warped, float* valid, int n,
                                        int c, int h, int w, int p,
                                        int border, int fast, void* stream) {
  if (n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast)
        launch<true, true>(img, ix, iy, mask, rgb, view, warped, valid, n, c,
                           h, w, p, s);
      else
        launch<true, false>(img, ix, iy, mask, rgb, view, warped, valid, n, c,
                            h, w, p, s);
    } else {
      if (fast)
        launch<false, true>(img, ix, iy, mask, rgb, view, warped, valid, n, c,
                            h, w, p, s);
      else
        launch<false, false>(img, ix, iy, mask, rgb, view, warped, valid, n,
                             c, h, w, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
