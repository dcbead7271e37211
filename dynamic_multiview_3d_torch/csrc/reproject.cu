// Fused depth reprojection: correspondence from depth and 12 camera
// scalars, zeros-padded bilinear sampling, validity; and the same with the
// mask composite.
//
// Replaces two TPU kernels of dynamic_multiview_3d_tpu/kernels/
// reproject_pallas.py:
//   _fused_kernel (called through _call_fused), the forward of
//     depth_reproject_sample: the geometric side view of flow synthesis with
//     predict_depth (entry dmv3d_reproject_sample_fwd);
//   _fused_composite_kernel (through _call_fused_composite), the forward of
//     depth_reproject_composite: depth synthesis's view (entry
//     dmv3d_reproject_composite_fwd).
//
// Per target pixel p of image n, with depth d (reproject.cuh):
//   (x, y), valid = the correspondence of (p, d) under the image's camera
//   geo[c]  = bilinear sample of channel c of source frame n / K at (x, y),
//             zeros padding, * valid
//   view[c] = mask * geo[c] + (1 - mask) * rgb[c]          (composite only)
// The reference's sample entry returns the sample and multiplies it by
// valid outside the kernel; here the kernel writes the product (a pixel
// that is not valid samples 0 at its far coordinate either way). Taps,
// weights and "fast" rounding are bilinear.cuh's: the outputs are bitwise
// those of the plain versions in kernels/reproject.py.
//
// The source frames are channels-last (the model's NHWC frames as an
// [N/K, C, H, W] view; the wrapper copies contiguous ones into that
// layout), one per example, shared by its K targets: target image n reads
// frame n / K (K = 1: one frame per target).
//
// Bound on an H100 SXM: memory. At the c2 shape (N = 128 target images of
// 3 x 128 x 128, P = 16,384 pixels each, from 16 shared frames read once,
// 3.1 MB) the sample entry moves depth, 3 geo and valid per pixel: 20
// B/pixel, 45 MB, about 13.5 us at 3.35 TB/s; the composite entry adds
// mask, 3 rgb and 3 view: 48 B/pixel, 104 MB, about 31 us. The
// arithmetic (~60 flops/pixel) is two orders below the f32 rate.
//
// Design: one thread per target pixel, looping over the channels. The
// thread reads its image's 12 scalars (the same addresses across a warp:
// one broadcast load each), then its depth, then the 4 taps per channel.
// Threads of a block cover consecutive pixels of one image, so the depth,
// mask and rgb reads and every output write are coalesced. The TPU's
// formulation (tent-weight matmuls over a VMEM-resident image, pixel blocks
// from a planner) does not carry over: a gather from L1/L2 is the natural
// CUDA form of the same sample. No shared memory, no atomics.

#include "bilinear.cuh"
#include "reproject.cuh"

namespace {

using dmv3d::Correspondence;
using dmv3d::Taps;
using dmv3d::dot2;

constexpr int kThreads = 256;
constexpr int kParams = 12;

template <bool kFast>
__global__ void __launch_bounds__(kThreads) reproject_sample_kernel(
    const float* __restrict__ params, const float* __restrict__ depth,
    const float* __restrict__ img, float* __restrict__ geo,
    float* __restrict__ valid, int c, int h, int w, int k) {
  const int p = h * w;
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const Correspondence cr(params + b * kParams, __ldg(depth + pix), q, w);
  const float val = cr.valid ? 1.f : 0.f;
  valid[pix] = val;
  const Taps<false, kFast> taps(cr.x, cr.y, h, w);
  const float* frame = img + (b / k) * p * c;          // its source frame
  for (int ch = 0; ch < c; ++ch) {
    float v[4];
    taps.load(frame + ch, c, v);
    geo[(b * c + ch) * p + q] =
        __fmul_rn(taps.lerp(taps.col0(v), taps.col1(v)), val);
  }
}

template <bool kFast>
__global__ void __launch_bounds__(kThreads) reproject_composite_kernel(
    const float* __restrict__ params, const float* __restrict__ depth,
    const float* __restrict__ img, const float* __restrict__ mask,
    const float* __restrict__ rgb, float* __restrict__ view,
    float* __restrict__ geo, float* __restrict__ valid, int c, int h, int w,
    int k) {
  const int p = h * w;
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const Correspondence cr(params + b * kParams, __ldg(depth + pix), q, w);
  const float val = cr.valid ? 1.f : 0.f;
  valid[pix] = val;
  const float m = __ldg(mask + pix);
  const float one_m = __fsub_rn(1.f, m);
  const Taps<false, kFast> taps(cr.x, cr.y, h, w);
  const float* frame = img + (b / k) * p * c;          // its source frame
  for (int ch = 0; ch < c; ++ch) {
    float v[4];
    taps.load(frame + ch, c, v);
    const float g = __fmul_rn(taps.lerp(taps.col0(v), taps.col1(v)), val);
    const int64_t o = (b * c + ch) * p + q;
    geo[o] = g;
    view[o] = dot2(m, g, one_m, __ldg(rgb + o));
  }
}

dim3 grid_of(int n, int h, int w) {
  return dim3((h * w + kThreads - 1) / kThreads, n);
}

}  // namespace

// params [n, 12]; depth, valid [n, h*w]; img [n / k, c, h, w]
// channels-last (its memory is [n / k, h, w, c]); geo [n, c, h*w]; all f32,
// on the device of `stream`, the others contiguous; k divides n. Returns
// cudaGetLastError().
extern "C" int dmv3d_reproject_sample_fwd(const float* params,
                                          const float* depth,
                                          const float* img, float* geo,
                                          float* valid, int n, int c, int h,
                                          int w, int k, int fast,
                                          void* stream) {
  if (n > 0 && h > 0 && w > 0 && k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast)
      reproject_sample_kernel<true><<<grid_of(n, h, w), kThreads, 0, s>>>(
          params, depth, img, geo, valid, c, h, w, k);
    else
      reproject_sample_kernel<false><<<grid_of(n, h, w), kThreads, 0, s>>>(
          params, depth, img, geo, valid, c, h, w, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// As dmv3d_reproject_sample_fwd, plus mask [n, h*w] and rgb, view
// [n, c, h*w].
extern "C" int dmv3d_reproject_composite_fwd(
    const float* params, const float* depth, const float* img,
    const float* mask, const float* rgb, float* view, float* geo,
    float* valid, int n, int c, int h, int w, int k, int fast,
    void* stream) {
  if (n > 0 && h > 0 && w > 0 && k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast)
      reproject_composite_kernel<true><<<grid_of(n, h, w), kThreads, 0, s>>>(
          params, depth, img, mask, rgb, view, geo, valid, c, h, w, k);
    else
      reproject_composite_kernel<false><<<grid_of(n, h, w), kThreads, 0, s>>>(
          params, depth, img, mask, rgb, view, geo, valid, c, h, w, k);
  }
  return static_cast<int>(cudaGetLastError());
}
