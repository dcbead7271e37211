// Backward of the fused multi-source warp + confidence blend + composite.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/multiflow_pallas.py
// _bwd_kernel (called through _call_bwd from _mf_bwd): the backward of
// multiflow_composite_pix on the multiflow and multidepth training paths.
// The forward is multiflow_composite.cu.
//
// Per target pixel p of example n, with cotangents d_view[c], d_multi[c]
// and d_wts[t] (d_multi and d_wts optional: null means zero, and nothing
// is read for them), recomputing the forward's weights and taps:
//   dm[c]     = d_view[c] * mask + d_multi[c]      (cotangent of multi)
//   ds[t,c]   = wts_t * dm[c]                      (of source t's sample)
//   d_ix_t    = sum_c ds * (ux0 * t0 + ux1 * t1)
//   d_iy_t    = sum_c ds * (wx0 * (uy0 v00 + uy1 v10)
//                           + wx1 * (uy0 v01 + uy1 v11))
//   g_t       = d_wts_t + sum_c dm[c] * sample_t[c]   (cotangent of wts_t)
//   gbar      = sum_t wts_t * g_t                      (t order)
//   d_conf_t  = wts_t * (g_t - gbar)                   (softmax Jacobian)
//   d_mask    = sum_c d_view[c] * (multi[c] - rgb[c])
//   d_rgb[c]  = d_view[c] * (1 - mask)
//   d_imgs_t += (wy * ds) * wx at each of the four taps    (optional)
// t0, t1 are the y-lerped columns x0 and x0+1 of the forward's sample; u is
// the TPU kernel's floor-tap subgradient (_tent_grad_t), as in
// warp_composite_bwd.cu. Sampling is under border padding, as in the
// forward; taps, weights, subgradients and the d_imgs scatter are
// bilinear.cuh's. The validity bias and any_valid have zero gradient.
// precision "fast" rounds what the TPU's fast backward rounds: image values
// and the y-weights of t0/t1 (as the forward); u is exact in bf16; wx stays
// f32 in the sample and d_iy; d_imgs takes bf16(wy * ds) x bf16(wx). Sums
// over channels run in channel order from 0, over sources in t order. Every
// operation is written with the _rn intrinsics so nvcc contracts nothing
// into an FMA; the order is that of multiflow_composite_pix_bwd_plain in
// kernels/multiflow.py (exp aside: CUDA's expf, see the forward).
//
// d_conf needs every g_s before gbar. This kernel parks g_t in the
// thread's own slot of the d_conf output during the sampling loop and
// overwrites it with d_conf_t in a last loop over the sources, which
// recomputes wts_t from the logits: recomputing g_t instead would sample
// all T frames a second time (4 gathers per source and channel), the
// parked value costs one store and one load per source from L2. The slot
// belongs to this thread alone, so no other thread sees the parked value.
//
// d_imgs is the one output several pixels write: the caller zeroes it and
// the kernel accumulates with atomicAdd, so its value depends on the order
// the atomics land in (a few ulp between runs). The training path never
// asks for it (the frames are data); the caller passes null then and the
// kernel has no atomics at all: d_ix, d_iy, d_conf, d_mask and d_rgb are
// each written by one thread, deterministically.
//
// Bound on an H100 SXM: memory. At the c3md shape (N = 8, T = 8, C = 3,
// 128², P = 32,768, 262,144 pixels), the multidepth training launch (d_multi
// given; no d_wts, no d_imgs) reads ix, iy, conf (24 values), mask, 3 rgb,
// 3 d_view, 3 d_multi and writes d_ix, d_iy, d_conf (24), d_mask, 3 d_rgb
// per pixel: 62 f32 values, 248 B; the frames are read once, 12.6 MB. 77.6
// MB in all: about 23.2 us at 3.35 TB/s. The multiflow launch (no d_multi)
// moves 236 B per pixel. The arithmetic (~0.3 GFLOP) is far below the f32
// rate.
//
// Design: one thread per target pixel, as in the forward: two loops over
// the sources for the softmax's max and denominator, one that samples,
// accumulates and writes d_ix, d_iy and the parked g, and one that turns
// the parked g into d_conf. The per-channel cotangents and blend sums sit
// in registers (at most kMaxChannels channels: the wrapper checks it).
// Threads of a block cover consecutive pixels of one example; no shared
// memory.

#include "bilinear.cuh"

namespace {

using dmv3d::blend_logit;

constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;

template <bool kFast>
__global__ void __launch_bounds__(kThreads) multiflow_bwd_kernel(
    const float* __restrict__ imgs, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ conf,
    const float* __restrict__ mask, const float* __restrict__ rgb,
    const float* __restrict__ d_view, const float* __restrict__ d_multi,
    const float* __restrict__ d_wts, float* __restrict__ d_imgs,
    float* __restrict__ d_ix, float* __restrict__ d_iy,
    float* __restrict__ d_conf, float* __restrict__ d_mask,
    float* __restrict__ d_rgb, int t, int c, int h, int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel of the example
  if (q >= p) return;
  const int64_t n = blockIdx.y;                        // example
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  const int64_t plane = static_cast<int64_t>(h) * w;

  // the forward's softmax: max, then denominator, each in t order
  float zmax = 0.f;
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float z = blend_logit(__ldg(ix + o), __ldg(iy + o),
                                __ldg(conf + o), wmax, hmax);
    zmax = s == 0 ? z : fmaxf(zmax, z);
  }
  float denom = 0.f;
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float z = blend_logit(__ldg(ix + o), __ldg(iy + o),
                                __ldg(conf + o), wmax, hmax);
    const float ez = expf(__fsub_rn(z, zmax));
    denom = s == 0 ? ez : __fadd_rn(denom, ez);
  }

  const int64_t pix = n * p + q;
  const float m = __ldg(mask + pix);
  const float one_m = __fsub_rn(1.f, m);
  float dv[kMaxChannels], dm[kMaxChannels], acc[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    dv[ch] = dm[ch] = acc[ch] = 0.f;
    if (ch < c) {
      const int64_t o = (n * c + ch) * p + q;
      dv[ch] = __ldg(d_view + o);
      dm[ch] = __fmul_rn(dv[ch], m);
      if (d_multi != nullptr) dm[ch] = __fadd_rn(dm[ch], __ldg(d_multi + o));
    }
  }

  float gbar = 0.f;
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float x = __ldg(ix + o);
    const float y = __ldg(iy + o);
    const float z = blend_logit(x, y, __ldg(conf + o), wmax, hmax);
    const float wt = __fdiv_rn(expf(__fsub_rn(z, zmax)), denom);
    const dmv3d::Taps<true, kFast> taps(x, y, h, w);
    const int64_t img0 = (n * t + s) * c * plane;

    float g = d_wts != nullptr ? __ldg(d_wts + o) : 0.f;
    float acc_x = 0.f, acc_y = 0.f;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) {
        float v[4];
        taps.load(imgs + img0 + ch * plane, v);
        const float t0 = taps.col0(v);
        const float t1 = taps.col1(v);
        const float val = taps.lerp(t0, t1);
        const float ds = __fmul_rn(wt, dm[ch]);
        acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wt, val));
        g = __fadd_rn(g, __fmul_rn(dm[ch], val));
        acc_x = __fadd_rn(acc_x, __fmul_rn(taps.grad_x(t0, t1), ds));
        acc_y = __fadd_rn(acc_y, __fmul_rn(taps.grad_y(v), ds));
        if (d_imgs != nullptr) taps.scatter(d_imgs + img0 + ch * plane, ds);
      }
    }
    d_ix[o] = acc_x;
    d_iy[o] = acc_y;
    d_conf[o] = g;  // parked until gbar is complete
    gbar = s == 0 ? __fmul_rn(wt, g) : __fadd_rn(gbar, __fmul_rn(wt, g));
  }

  // the softmax Jacobian, over the parked g
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float z = blend_logit(__ldg(ix + o), __ldg(iy + o),
                                __ldg(conf + o), wmax, hmax);
    const float wt = __fdiv_rn(expf(__fsub_rn(z, zmax)), denom);
    d_conf[o] = __fmul_rn(wt, __fsub_rn(d_conf[o], gbar));
  }

  float acc_m = 0.f;
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    if (ch < c) {
      const int64_t o = (n * c + ch) * p + q;
      acc_m = __fadd_rn(acc_m,
                        __fmul_rn(dv[ch], __fsub_rn(acc[ch], __ldg(rgb + o))));
      d_rgb[o] = __fmul_rn(dv[ch], one_m);
    }
  }
  d_mask[pix] = acc_m;
}

template <bool kFast>
void launch(const float* imgs, const float* ix, const float* iy,
            const float* conf, const float* mask, const float* rgb,
            const float* d_view, const float* d_multi, const float* d_wts,
            float* d_imgs, float* d_ix, float* d_iy, float* d_conf,
            float* d_mask, float* d_rgb, int n, int t, int c, int h, int w,
            int p, cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  multiflow_bwd_kernel<kFast><<<grid, kThreads, 0, stream>>>(
      imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts, d_imgs, d_ix,
      d_iy, d_conf, d_mask, d_rgb, t, c, h, w, p);
}

}  // namespace

// imgs, d_imgs [n, t, c, h, w]; ix, iy, conf, d_wts, d_ix, d_iy, d_conf
// [n, t, p]; mask, d_mask [n, p]; rgb, d_view, d_multi, d_rgb [n, c, p];
// all f32, contiguous, on the device of `stream`; t >= 1, c <= 16. d_multi
// and d_wts may be null (zero); d_imgs may be null (not computed), else it
// must hold zeros. Returns cudaGetLastError().
extern "C" int dmv3d_multiflow_composite_bwd(
    const float* imgs, const float* ix, const float* iy, const float* conf,
    const float* mask, const float* rgb, const float* d_view,
    const float* d_multi, const float* d_wts, float* d_imgs, float* d_ix,
    float* d_iy, float* d_conf, float* d_mask, float* d_rgb, int n, int t,
    int c, int h, int w, int p, int fast, void* stream) {
  if (c > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && p > 0 && t > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast)
      launch<true>(imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts,
                   d_imgs, d_ix, d_iy, d_conf, d_mask, d_rgb, n, t, c, h, w,
                   p, s);
    else
      launch<false>(imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts,
                    d_imgs, d_ix, d_iy, d_conf, d_mask, d_rgb, n, t, c, h, w,
                    p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
