// Plain bilinear sampler at pixel coordinates.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _fwd_kernel (called through _call_fwd), the forward of sample_pixel_coords
// behind the public grid_sample and flow_warp; depth synthesis reaches it
// through flow_warp for its "warped" output.
//
// Per output pixel p of image n, with pixel coordinates (ix, iy):
//   border:   clamp (ix, iy) to the image, then sample bilinearly
//   zeros:    taps outside the image get weight 0
//   out[c]  = bilinear sample of channel c
// The taps, weights and rounding ("fast": bf16 image values and y-weights)
// are bilinear.cuh's, shared with every other kernel of the port: the
// result is bitwise that of sample_pixel_coords_plain in
// kernels/grid_sample.py. The backward is warp_composite_bwd.cu's
// no-composite launch.
//
// Bound on an H100 SXM: memory. At the c2 shape (N = 128 images of 3 x 128
// x 128, P = 16,384 pixels each) every pixel moves ix, iy, 3 source taps
// (the image read once) and 3 outputs: 32 B/pixel, 67 MB in all, about 20 us
// at 3.35 TB/s. The arithmetic (~40 flops/pixel) is two orders below the
// f32 rate.
//
// Design: one thread per output pixel, looping over the channels; threads
// of a block cover consecutive pixels of one image, so the coordinate reads
// and the output writes are coalesced, and the four tap gathers per channel
// come from one image in L1/L2. No shared memory, no atomics.

#include "bilinear.cuh"

namespace {

using dmv3d::Taps;

constexpr int kThreads = 256;

template <bool kBorder, bool kFast>
__global__ void __launch_bounds__(kThreads) sample_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, float* __restrict__ out, int c, int h,
    int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const Taps<kBorder, kFast> taps(__ldg(ix + pix), __ldg(iy + pix), h, w);
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int ch = 0; ch < c; ++ch) {
    float v[4];
    taps.load(img + (b * c + ch) * plane, v);
    out[(b * c + ch) * p + q] = taps.lerp(taps.col0(v), taps.col1(v));
  }
}

template <bool kBorder, bool kFast>
void launch(const float* img, const float* ix, const float* iy, float* out,
            int n, int c, int h, int w, int p, cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  sample_fwd_kernel<kBorder, kFast><<<grid, kThreads, 0, stream>>>(
      img, ix, iy, out, c, h, w, p);
}

}  // namespace

// img [n, c, h, w]; ix, iy [n, p]; out [n, c, p]; all f32, contiguous, on
// the device of `stream`. Returns cudaGetLastError().
extern "C" int dmv3d_sample_fwd(const float* img, const float* ix,
                                const float* iy, float* out, int n, int c,
                                int h, int w, int p, int border, int fast,
                                void* stream) {
  if (n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast)
        launch<true, true>(img, ix, iy, out, n, c, h, w, p, s);
      else
        launch<true, false>(img, ix, iy, out, n, c, h, w, p, s);
    } else {
      if (fast)
        launch<false, true>(img, ix, iy, out, n, c, h, w, p, s);
      else
        launch<false, false>(img, ix, iy, out, n, c, h, w, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
