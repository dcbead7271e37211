// Backward of the fused depth reprojection (reproject.cu), both entries.
//
// Replaces what dynamic_multiview_3d_tpu/kernels/reproject_pallas.py runs
// for the VJPs of depth_reproject_sample (_bwd) and depth_reproject_composite
// (_cmp_bwd): the composite's chain rule and the validity mask in XLA, the
// TPU kernel grid_sample_pallas._bwd_kernel (zeros padding) for the
// sampler's backward, then _coords_and_ddepth's chain rule to the depth in
// XLA. Here all of it is one kernel: nothing per pixel goes through device
// memory between the steps (the reference's XLA form keeps ix, iy and both
// d/d depth terms, four [N, P] f32 arrays, and runs about 20 launches).
//
// Per target pixel p of image n, recomputing the forward's correspondence
// (reproject.cuh) and taps (bilinear.cuh):
//   composite launch (mask given):
//     geo[c]  = sample[c] * valid                      (as the forward)
//     dg[c]   = d_view[c] * mask + d_geo[c]            (d_geo may be null)
//     d_rgb[c]= d_view[c] * (1 - mask)
//     d_mask  = sum_c d_view[c] * (geo[c] - rgb[c])
//   sample launch (mask null): dg[c] = d_geo[c]
//   ds[c]   = dg[c] * valid                            (sample cotangent)
//   d_x     = sum_c ds * (ux0 * t0 + ux1 * t1)         floor-tap
//   d_y     = sum_c ds * (wx0 (uy0 v00 + uy1 v10) + wx1 (uy0 v01 + uy1 v11))
//   d_depth = d_x * dx/dd + d_y * dy/dd                (0 where not valid)
//   d_img  += (wy * ds) * wx at each of the four taps  (optional)
// under zeros padding, with site #3's "fast" rounding (bf16 image values
// and y-weights of t0/t1; d_img takes bf16(wy * ds) x bf16(wx)). The camera
// scalars get no gradient (fixed inputs in the reference too). Sums run
// over channels in channel order, from 0. d_depth, d_mask and d_rgb are
// bitwise those of reproject_pix_bwd_plain in kernels/reproject.py.
//
// d_img is the one output several pixels write: zeroed by the caller and
// accumulated with atomicAdd, so it depends on the order the atomics land
// in (a few ulp between runs). The model's path never asks for it (the
// reprojected frame is data) and passes null: the kernel then has no
// atomics at all.
//
// Bound on an H100 SXM: memory. At the c2 shape (N = 128 images of 3 x 128
// x 128, P = 16,384), the composite launch of depth synthesis's training
// step (d_view and d_geo, no d_img) reads depth, mask, 3 rgb, 3 d_view, 3
// d_geo and the image once, and writes d_depth, d_mask and 3 d_rgb: 76
// B/pixel, 159 MB, about 48 us at 3.35 TB/s. The sample launch of the
// geometric side view reads depth, 3 d_geo and the image, and writes
// d_depth: 32 B/pixel, 67 MB, about 20 us. The arithmetic (~150
// flops/pixel) is two orders below the f32 rate.
//
// Design: one thread per target pixel, looping over the channels, as in the
// forward; threads of a block cover consecutive pixels of one image, so
// every per-pixel read and write is coalesced and the tap gathers come from
// one image in L1/L2. No shared memory.

#include "bilinear.cuh"
#include "reproject.cuh"

namespace {

using dmv3d::Correspondence;
using dmv3d::Taps;

constexpr int kThreads = 256;
constexpr int kParams = 12;

template <bool kComposite, bool kFast>
__global__ void __launch_bounds__(kThreads) reproject_bwd_kernel(
    const float* __restrict__ params, const float* __restrict__ depth,
    const float* __restrict__ img, const float* __restrict__ mask,
    const float* __restrict__ rgb, const float* __restrict__ d_view,
    const float* __restrict__ d_geo, float* __restrict__ d_img,
    float* __restrict__ d_depth, float* __restrict__ d_mask,
    float* __restrict__ d_rgb, int c, int h, int w) {
  const int p = h * w;
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const Correspondence cr(params + b * kParams, __ldg(depth + pix), q, w);
  const float val = cr.valid ? 1.f : 0.f;
  const Taps<false, kFast> taps(cr.x, cr.y, h, w);
  const float m = kComposite ? __ldg(mask + pix) : 0.f;
  const float one_m = __fsub_rn(1.f, m);
  const int64_t plane = static_cast<int64_t>(p);

  float acc_x = 0.f, acc_y = 0.f, acc_m = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    float v[4];
    taps.load(img + (b * c + ch) * plane, v);
    const float t0 = taps.col0(v);
    const float t1 = taps.col1(v);
    const int64_t o = (b * c + ch) * p + q;
    float dg;
    if (kComposite) {
      const float g = __fmul_rn(taps.lerp(t0, t1), val);
      const float dv = __ldg(d_view + o);
      dg = __fmul_rn(dv, m);
      if (d_geo != nullptr) dg = __fadd_rn(dg, __ldg(d_geo + o));
      d_rgb[o] = __fmul_rn(dv, one_m);
      acc_m = __fadd_rn(acc_m, __fmul_rn(dv, __fsub_rn(g, __ldg(rgb + o))));
    } else {
      dg = __ldg(d_geo + o);
    }
    const float ds = __fmul_rn(dg, val);
    acc_x = __fadd_rn(acc_x, __fmul_rn(taps.grad_x(t0, t1), ds));
    acc_y = __fadd_rn(acc_y, __fmul_rn(taps.grad_y(v), ds));
    if (d_img != nullptr) taps.scatter(d_img + (b * c + ch) * plane, ds);
  }
  d_depth[pix] = cr.d_depth(acc_x, acc_y);
  if (kComposite) d_mask[pix] = acc_m;
}

template <bool kComposite, bool kFast>
void launch(const float* params, const float* depth, const float* img,
            const float* mask, const float* rgb, const float* d_view,
            const float* d_geo, float* d_img, float* d_depth, float* d_mask,
            float* d_rgb, int n, int c, int h, int w, cudaStream_t stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  reproject_bwd_kernel<kComposite, kFast><<<grid, kThreads, 0, stream>>>(
      params, depth, img, mask, rgb, d_view, d_geo, d_img, d_depth, d_mask,
      d_rgb, c, h, w);
}

}  // namespace

// params [n, 12]; depth, mask, d_depth, d_mask [n, h*w]; img, d_img
// [n, c, h, w]; rgb, d_view, d_geo, d_rgb [n, c, h*w]; all f32, contiguous,
// on the device of `stream`. A null mask is the sample launch: mask, rgb,
// d_view, d_mask and d_rgb are null and d_geo is required. In the composite
// launch d_geo may be null (zero). d_img may be null (not computed), else it
// must hold zeros. Returns cudaGetLastError().
extern "C" int dmv3d_reproject_bwd(const float* params, const float* depth,
                                   const float* img, const float* mask,
                                   const float* rgb, const float* d_view,
                                   const float* d_geo, float* d_img,
                                   float* d_depth, float* d_mask,
                                   float* d_rgb, int n, int c, int h, int w,
                                   int fast, void* stream) {
  if (n > 0 && h > 0 && w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mask != nullptr) {
      if (fast)
        launch<true, true>(params, depth, img, mask, rgb, d_view, d_geo,
                           d_img, d_depth, d_mask, d_rgb, n, c, h, w, s);
      else
        launch<true, false>(params, depth, img, mask, rgb, d_view, d_geo,
                            d_img, d_depth, d_mask, d_rgb, n, c, h, w, s);
    } else {
      if (fast)
        launch<false, true>(params, depth, img, mask, rgb, d_view, d_geo,
                            d_img, d_depth, d_mask, d_rgb, n, c, h, w, s);
      else
        launch<false, false>(params, depth, img, mask, rgb, d_view, d_geo,
                             d_img, d_depth, d_mask, d_rgb, n, c, h, w, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
