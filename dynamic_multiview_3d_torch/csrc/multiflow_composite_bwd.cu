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
// warp_composite_bwd.cu. Sampling is under the forward's padding (border
// or zeros: the library's DMV3D_MF_BORDER, multiflow.cuh); taps, weights,
// subgradients and the d_imgs scatter are bilinear.cuh's, the weights
// multiflow.cuh's. The validity bias and any_valid have zero gradient.
// precision "fast" rounds what the TPU's fast backward rounds: image values
// and the y-weights of t0/t1 (as the forward); u is exact in bf16; wx stays
// f32 in the sample and d_iy; d_imgs takes bf16(wy * ds) x bf16(wx). Sums over channels run in channel
// order from 0, over sources in t order. Every operation is written with
// the _rn intrinsics so nvcc contracts nothing into an FMA; the order is
// that of multiflow_composite_pix_bwd_plain in kernels/multiflow.py (exp
// aside: CUDA's expf, see the forward).
//
// d_imgs is the one output several pixels write: the caller zeroes it
// (channels-last, as imgs) and the kernel accumulates with atomicAdd, so
// its value depends on the order the atomics land in (a few ulp between
// runs). The training path never asks for it (the frames are data); the
// caller passes null then and the kernel has no atomics at all: d_ix, d_iy,
// d_conf, d_mask and d_rgb are each written once by one thread,
// deterministically.
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
// Design: the forward's (multiflow_composite.cu), for the same reason:
// the scattered tap gathers' traffic between L2 and the SMs, not device
// memory, holds it. Channels-last frames put a tap's channels in one
// sector; T is a compile-time constant, so each source's ix, iy, conf (and
// d_wts) are read once into registers, and its weight, g_t and the d_ix /
// d_iy sums stay there. The sources' loop unrolls, so their tap loads are
// in flight together. g_t stays in registers until gbar is complete, so
// d_conf is written once. C <= 3 has its own instantiations (kOnePass), as
// in the forward, and so does d_imgs (kImg: the training launch carries no
// scatter code). Unbounded, ptxas would hoist every source's taps into up
// to 255 registers a thread and leave an SM 256 threads; the one-pass
// instantiations take a register budget that grows with T as their launch
// bound (multiflow.cuh, bwd_min_blocks). One thread per target pixel of
// one example, in blocks of kBwdThreads (multiflow.cuh: 128, chosen by
// measurement); no shared memory.

#include "bilinear.cuh"
#include "multiflow.cuh"

namespace {

using dmv3d::mf::kBwdThreads;
using dmv3d::mf::kGroup;

template <int T, bool kBorder, bool kFast, bool kImg, bool kOnePass>
__global__ void __launch_bounds__(kBwdThreads,
                                  kOnePass ? dmv3d::mf::bwd_min_blocks(T) : 1)
    multiflow_bwd_kernel(
    const float* __restrict__ imgs, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ conf,
    const float* __restrict__ mask, const float* __restrict__ rgb,
    const float* __restrict__ d_view, const float* __restrict__ d_multi,
    const float* __restrict__ d_wts, float* __restrict__ d_imgs,
    float* __restrict__ d_ix, float* __restrict__ d_iy,
    float* __restrict__ d_conf, float* __restrict__ d_mask,
    float* __restrict__ d_rgb, int c, int h, int w, int p) {
  const int q = blockIdx.x * kBwdThreads + threadIdx.x;  // pixel
  if (q >= p) return;
  const int64_t n = blockIdx.y;                           // example
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  const int64_t frame_size = static_cast<int64_t>(h) * w * c;
  const int64_t frames = n * T * frame_size;

  // the forward's weights; per source the cotangent of its weight (g) and
  // the coordinate gradients, summed over the channels
  float x[T], y[T], wt[T], anyv;
  dmv3d::mf::blend<T>(ix, iy, conf, n * T * p + q, p, wmax, hmax, x, y, wt,
                      anyv);
  float g[T], gx[T], gy[T];
#pragma unroll
  for (int s = 0; s < T; ++s) {
    g[s] = d_wts != nullptr ? __ldg(d_wts + (n * T + s) * p + q) : 0.f;
    gx[s] = gy[s] = 0.f;
  }
  const float m = __ldg(mask + n * p + q);
  const float one_m = __fsub_rn(1.f, m);
  float acc_m = 0.f;

  // kOnePass (c <= kGroup, every model path): one pass, straight-line
  // code, in which each source's coordinates and sums die after its taps
  for (int c0 = 0; c0 < (kOnePass ? 1 : c); c0 += kGroup) {
    // past the last channel, the last one again (no branch): its sums are
    // never used, and nothing is added to the per-source ones
    float dv[kGroup], dm[kGroup], acc[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int64_t o = (n * c + min(c0 + k, c - 1)) * p + q;
      dv[k] = __ldg(d_view + o);
      dm[k] = __fmul_rn(dv[k], m);
      if (d_multi != nullptr) dm[k] = __fadd_rn(dm[k], __ldg(d_multi + o));
      acc[k] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < T; ++s) {
      const int64_t frame = frames + s * frame_size;
      const dmv3d::Taps<kBorder, kFast> taps(x[s], y[s], h, w);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const bool live = c0 + k < c;
        const int ch = min(c0 + k, c - 1);
        float v[4];
        taps.load(imgs + frame + ch, c, v);
        const float t0 = taps.col0(v);
        const float t1 = taps.col1(v);
        const float val = taps.lerp(t0, t1);
        const float ds = __fmul_rn(wt[s], dm[k]);
        acc[k] = __fadd_rn(acc[k], __fmul_rn(wt[s], val));
        // selects, not branches: the T sources stay one block of code
        const float gn = __fadd_rn(g[s], __fmul_rn(dm[k], val));
        const float gxn = __fadd_rn(gx[s], __fmul_rn(taps.grad_x(t0, t1), ds));
        const float gyn = __fadd_rn(gy[s], __fmul_rn(taps.grad_y(v), ds));
        g[s] = live ? gn : g[s];
        gx[s] = live ? gxn : gx[s];
        gy[s] = live ? gyn : gy[s];
        if constexpr (kImg) {   // on request only: atomics
          if (live) taps.scatter(d_imgs + frame + ch, c, ds);
        }
      }
      if constexpr (kOnePass) {   // complete: out of the registers now
        d_ix[(n * T + s) * p + q] = gx[s];
        d_iy[(n * T + s) * p + q] = gy[s];
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (c0 + k < c) {
        const int64_t o = (n * c + c0 + k) * p + q;
        acc_m = __fadd_rn(acc_m,
                          __fmul_rn(dv[k], __fsub_rn(acc[k], __ldg(rgb + o))));
        d_rgb[o] = __fmul_rn(dv[k], one_m);
      }
    }
  }

  // the softmax Jacobian, every g_t at hand
  float gbar = 0.f;
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const float term = __fmul_rn(wt[s], g[s]);
    gbar = s == 0 ? term : __fadd_rn(gbar, term);
  }
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const int64_t o = (n * T + s) * p + q;
    d_conf[o] = __fmul_rn(wt[s], __fsub_rn(g[s], gbar));
    if constexpr (!kOnePass) {
      d_ix[o] = gx[s];
      d_iy[o] = gy[s];
    }
  }
  d_mask[n * p + q] = acc_m;
}

// kImg: d_imgs is computed (its own instantiations, so that the training
// launch carries no scatter code; they take every C in passes)
template <bool kFast, bool kImg, bool kOnePass>
void launch(const float* imgs, const float* ix, const float* iy,
            const float* conf, const float* mask, const float* rgb,
            const float* d_view, const float* d_multi, const float* d_wts,
            float* d_imgs, float* d_ix, float* d_iy, float* d_conf,
            float* d_mask, float* d_rgb, int n, int c, int h, int w, int p,
            cudaStream_t stream) {
  multiflow_bwd_kernel<dmv3d::mf::kSources, dmv3d::mf::kBorder, kFast, kImg,
                       kOnePass>
      <<<dmv3d::mf::grid(n, p, kBwdThreads), kBwdThreads, 0, stream>>>(
          imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts, d_imgs,
          d_ix, d_iy, d_conf, d_mask, d_rgb, c, h, w, p);
}

template <bool kFast>
void dispatch(const float* imgs, const float* ix, const float* iy,
              const float* conf, const float* mask, const float* rgb,
              const float* d_view, const float* d_multi, const float* d_wts,
              float* d_imgs, float* d_ix, float* d_iy, float* d_conf,
              float* d_mask, float* d_rgb, int n, int c, int h, int w, int p,
              cudaStream_t stream) {
  if (d_imgs != nullptr)
    launch<kFast, true, false>(imgs, ix, iy, conf, mask, rgb, d_view,
                               d_multi, d_wts, d_imgs, d_ix, d_iy, d_conf,
                               d_mask, d_rgb, n, c, h, w, p, stream);
  else if (c <= kGroup)
    launch<kFast, false, true>(imgs, ix, iy, conf, mask, rgb, d_view,
                               d_multi, d_wts, d_imgs, d_ix, d_iy, d_conf,
                               d_mask, d_rgb, n, c, h, w, p, stream);
  else
    launch<kFast, false, false>(imgs, ix, iy, conf, mask, rgb, d_view,
                                d_multi, d_wts, d_imgs, d_ix, d_iy, d_conf,
                                d_mask, d_rgb, n, c, h, w, p, stream);
}

}  // namespace

// imgs, d_imgs [n, t, c, h, w], both channels-last (their memory is
// [n, t, h, w, c]); ix, iy, conf, d_wts, d_ix, d_iy, d_conf [n, t, p];
// mask, d_mask [n, p]; rgb, d_view, d_multi, d_rgb [n, c, p]; all f32, on
// the device of `stream`, the others contiguous; t the library's
// DMV3D_MF_T, c <= 16.
// d_multi and d_wts may be null (zero); d_imgs may be null (not computed),
// else it must hold zeros. Returns cudaGetLastError().
extern "C" int dmv3d_multiflow_composite_bwd(
    const float* imgs, const float* ix, const float* iy, const float* conf,
    const float* mask, const float* rgb, const float* d_view,
    const float* d_multi, const float* d_wts, float* d_imgs, float* d_ix,
    float* d_iy, float* d_conf, float* d_mask, float* d_rgb, int n, int t,
    int c, int h, int w, int p, int fast, void* stream) {
  if (c > dmv3d::mf::kMaxChannels || t != dmv3d::mf::kSources)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast)
      dispatch<true>(imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts,
                     d_imgs, d_ix, d_iy, d_conf, d_mask, d_rgb, n, c, h, w, p,
                     s);
    else
      dispatch<false>(imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts,
                      d_imgs, d_ix, d_iy, d_conf, d_mask, d_rgb, n, c, h, w,
                      p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
