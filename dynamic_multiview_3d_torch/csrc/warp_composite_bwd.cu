// Backward of the fused appearance-flow warp + mask composite.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _bwd_kernel (called through _call_bwd) together with the chain rule of
// _wc_bwd around it: the backward of flow_warp_composite on the model's
// training path. The forward is warp_composite.cu.
//
// Per output pixel p of image n, with cotangents d_view[c] and d_warped[c]
// (optional: null means zero), recomputing the forward's taps:
//   t0[c], t1[c] = the y-lerped columns x0 and x0+1 (as in the forward)
//   warped[c]    = wx0 * t0 + wx1 * t1
//   ds[c]        = d_view * mask + d_warped             (sample cotangent)
//   d_rgb[c]     = d_view * (1 - mask)
//   d_mask       = sum_c d_view * (warped - rgb)
//   d_ix         = sum_c ds * (ux0 * t0 + ux1 * t1)
//   d_iy         = sum_c ds * (wx0 * (uy0 v00 + uy1 v10)
//                             + wx1 * (uy0 v01 + uy1 v11))
//   d_img        += (wy * ds) * wx at each of the four taps   (optional)
// u is the TPU kernel's floor-tap subgradient (_tent_grad_t), so a
// coordinate exactly on the far edge gets -v(edge) under border padding.
// precision "fast" rounds what the TPU's fast backward rounds (single-pass
// bf16 matmuls): image values and the y-weights of t0/t1, as the forward;
// u is exact in bf16; wx stays f32 in d_iy; d_img takes bf16(wy * ds) x
// bf16(wx). Taps, weights, subgradients and the d_img scatter are
// bilinear.cuh's. Sums run over channels in channel order, from 0. d_ix,
// d_iy, d_mask and d_rgb are bitwise those of warp_composite_pix_bwd_plain
// in kernels/grid_sample.py.
//
// The no-composite launch (null mask, rgb, d_view, d_mask and d_rgb) is the
// backward of the plain sampler sample.cu (the TPU's _sample_bwd around
// _bwd_kernel): ds = d_warped, and only d_ix, d_iy and d_img are written.
//
// d_img is the one output several pixels write: it is zeroed by the caller
// and accumulated with atomicAdd, so its value depends on the order the
// atomics land in (a few ulp between runs). The model's path never asks
// for it (the warped frame is data); the caller passes null then and the
// kernel has no atomics at all.
//
// Bound on an H100 SXM: memory. At the c2 training shape (N = 128 images of
// 3 x 128 x 128, P = 16,384, 2.10 M pixels) without d_img and d_warped,
// every pixel reads 12 f32 values (ix, iy, mask, 3 rgb, 3 d_view, the image
// once) and writes 6 (d_ix, d_iy, d_mask, 3 d_rgb): 72 B/pixel, 151 MB, about
// 45 us at 3.35 TB/s. The arithmetic (~130 flops/pixel) is two orders below
// the f32 rate. d_img adds 12 B/pixel of output (and the caller's zeroing).
//
// Design: one thread per output pixel, as in the forward, looping over the
// channels; threads of a block cover consecutive pixels of one image, so
// every per-pixel read and write is coalesced and the tap gathers come from
// one image in L1/L2. No shared memory.

#include "bilinear.cuh"

namespace {

using dmv3d::Taps;

constexpr int kThreads = 256;

template <bool kBorder, bool kFast, bool kComposite>
__global__ void __launch_bounds__(kThreads) warp_composite_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ mask,
    const float* __restrict__ rgb, const float* __restrict__ d_view,
    const float* __restrict__ d_warped, float* __restrict__ d_img,
    float* __restrict__ d_ix, float* __restrict__ d_iy,
    float* __restrict__ d_mask, float* __restrict__ d_rgb, int c, int h,
    int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const Taps<kBorder, kFast> taps(__ldg(ix + pix), __ldg(iy + pix), h, w);
  const float m = kComposite ? __ldg(mask + pix) : 0.f;
  const float one_m = __fsub_rn(1.f, m);
  const int64_t plane = static_cast<int64_t>(h) * w;

  float acc_x = 0.f, acc_y = 0.f, acc_m = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    float v[4];
    taps.load(img + (b * c + ch) * plane, v);
    const float t0 = taps.col0(v);
    const float t1 = taps.col1(v);
    const int64_t o = (b * c + ch) * p + q;
    float ds;
    if (kComposite) {
      const float s = taps.lerp(t0, t1);
      const float dv = __ldg(d_view + o);
      ds = __fmul_rn(dv, m);
      if (d_warped != nullptr) ds = __fadd_rn(ds, __ldg(d_warped + o));
      d_rgb[o] = __fmul_rn(dv, one_m);
      acc_m = __fadd_rn(acc_m, __fmul_rn(dv, __fsub_rn(s, __ldg(rgb + o))));
    } else {
      ds = __ldg(d_warped + o);
    }
    acc_x = __fadd_rn(acc_x, __fmul_rn(taps.grad_x(t0, t1), ds));
    acc_y = __fadd_rn(acc_y, __fmul_rn(taps.grad_y(v), ds));
    if (d_img != nullptr) taps.scatter(d_img + (b * c + ch) * plane, ds);
  }
  d_ix[pix] = acc_x;
  d_iy[pix] = acc_y;
  if (kComposite) d_mask[pix] = acc_m;
}

template <bool kBorder, bool kFast>
void launch(const float* img, const float* ix, const float* iy,
            const float* mask, const float* rgb, const float* d_view,
            const float* d_warped, float* d_img, float* d_ix, float* d_iy,
            float* d_mask, float* d_rgb, int n, int c, int h, int w, int p,
            cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  if (mask != nullptr)
    warp_composite_bwd_kernel<kBorder, kFast, true>
        <<<grid, kThreads, 0, stream>>>(img, ix, iy, mask, rgb, d_view,
                                        d_warped, d_img, d_ix, d_iy, d_mask,
                                        d_rgb, c, h, w, p);
  else
    warp_composite_bwd_kernel<kBorder, kFast, false>
        <<<grid, kThreads, 0, stream>>>(img, ix, iy, mask, rgb, d_view,
                                        d_warped, d_img, d_ix, d_iy, d_mask,
                                        d_rgb, c, h, w, p);
}

}  // namespace

// img, d_img [n, c, h, w]; ix, iy, mask, d_ix, d_iy, d_mask [n, p];
// rgb, d_view, d_warped, d_rgb [n, c, p]; all f32, contiguous, on the device
// of `stream`. d_warped may be null (zero); d_img may be null (not
// computed), else it must hold zeros. A null mask is the no-composite
// launch: mask, rgb, d_view, d_mask and d_rgb are null and d_warped is the
// sample's cotangent. Returns cudaGetLastError().
extern "C" int dmv3d_warp_composite_bwd(
    const float* img, const float* ix, const float* iy, const float* mask,
    const float* rgb, const float* d_view, const float* d_warped,
    float* d_img, float* d_ix, float* d_iy, float* d_mask, float* d_rgb,
    int n, int c, int h, int w, int p, int border, int fast, void* stream) {
  if (n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast)
        launch<true, true>(img, ix, iy, mask, rgb, d_view, d_warped, d_img,
                           d_ix, d_iy, d_mask, d_rgb, n, c, h, w, p, s);
      else
        launch<true, false>(img, ix, iy, mask, rgb, d_view, d_warped, d_img,
                            d_ix, d_iy, d_mask, d_rgb, n, c, h, w, p, s);
    } else {
      if (fast)
        launch<false, true>(img, ix, iy, mask, rgb, d_view, d_warped, d_img,
                            d_ix, d_iy, d_mask, d_rgb, n, c, h, w, p, s);
      else
        launch<false, false>(img, ix, iy, mask, rgb, d_view, d_warped, d_img,
                             d_ix, d_iy, d_mask, d_rgb, n, c, h, w, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
