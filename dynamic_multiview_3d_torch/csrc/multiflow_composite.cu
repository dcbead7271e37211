// Fused multi-source warp + confidence blend + mask composite.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/multiflow_pallas.py
// _fwd_kernel (called through _call_fwd), the forward of
// multiflow_composite_pix on the multiflow and multidepth synthesis paths.
//
// Per target pixel p of example n, over the T source frames t, with pixel
// coordinates (ix_t, iy_t) and confidence logits conf_t:
//   valid_t   = 0 <= ix_t <= W-1 and 0 <= iy_t <= H-1    (unclamped)
//   z_t       = conf_t + (valid_t - 1) * 30
//   zmax      = max_t z_t                  (t ascending)
//   wts_t     = exp(z_t - zmax) / sum_s exp(z_s - zmax)  (sum in s order)
//   multi[c]  = sum_t wts_t * sample_t[c]  (from 0, t order)
//   view[c]   = mask * multi[c] + (1 - mask) * rgb[c]
//   any_valid = max_t valid_t
// sample_t is the bilinear sample of source t under border padding (the
// coordinate clamped into the image), with bilinear.cuh's taps: the y-taps
// are combined first, then the x-taps, as in warp_composite.cu. precision
// "fast" rounds the image values and the y-tap weights to bf16 (what the
// TPU's single-pass bf16 matmul does); x-weights and sums stay f32. Every
// product, sum and quotient is written with the _rn intrinsics so nvcc
// contracts nothing into an FMA; the order is that of the plain PyTorch
// version in kernels/multiflow.py. exp is CUDA's expf (no fast math), so
// the weights may differ from the plain version's by an ulp or two of
// their value.
//
// Bound on an H100 SXM: memory. At the c3md shape (N = 8 examples, T = 8
// sources of 3 x 128 x 128, P = K*H*W = 32,768 target pixels, 262,144 in
// all) each pixel reads ix, iy, conf (3T = 24 values), mask and 3 rgb, and
// writes 3 view, 3 multi, 1 any_valid and T = 8 weights: 43 f32 values,
// 172 B; the source frames are read once, 12.6 MB. 57.7 MB in all: about
// 17.2 us at 3.35 TB/s. The arithmetic (~0.14 GFLOP, one exp per pixel and
// source, twice) is two orders below the f32 rate.
//
// Design: one thread per target pixel, three loops over the sources:
// (1) the logits' max and any_valid, (2) the softmax denominator, (3) the
// weights, the samples and the blend. Each loop recomputes the logit from
// ix, iy and conf (re-read from L1/L2, not device memory) instead of
// keeping T values per thread, so T has no upper bound and no online
// rescaling changes the reference's order of operations. The per-channel
// sums sit in registers (at most kMaxChannels channels: the wrapper checks
// it). Threads of a block cover consecutive pixels of one example, so every
// per-pixel read and write is coalesced; the tap gathers come from the T
// frames of one example, which stay in L2 (1.5 MB per example at c3md). No
// shared memory, no atomics: every output is written once by one thread.

#include "bilinear.cuh"

namespace {

using dmv3d::blend_logit;
using dmv3d::dot2;

constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;

template <bool kFast>
__global__ void __launch_bounds__(kThreads) multiflow_fwd_kernel(
    const float* __restrict__ imgs, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ conf,
    const float* __restrict__ mask, const float* __restrict__ rgb,
    float* __restrict__ view, float* __restrict__ multi,
    float* __restrict__ any_valid, float* __restrict__ wts, int t, int c,
    int h, int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel of the example
  if (q >= p) return;
  const int64_t n = blockIdx.y;                        // example
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  const int64_t plane = static_cast<int64_t>(h) * w;

  // (1) the logits' max over the sources, in t order, and any_valid
  float zmax = 0.f, anyv = 0.f;
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float x = __ldg(ix + o);
    const float y = __ldg(iy + o);
    const float z = blend_logit(x, y, __ldg(conf + o), wmax, hmax);
    zmax = s == 0 ? z : fmaxf(zmax, z);
    anyv = fmaxf(anyv, dmv3d::in_bounds(x, y, wmax, hmax));
  }
  // (2) the softmax denominator, summed in t order
  float denom = 0.f;
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float z = blend_logit(__ldg(ix + o), __ldg(iy + o),
                                __ldg(conf + o), wmax, hmax);
    const float ez = expf(__fsub_rn(z, zmax));
    denom = s == 0 ? ez : __fadd_rn(denom, ez);
  }
  // (3) the weights, each source's samples, the blend
  float acc[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) acc[ch] = 0.f;
  for (int s = 0; s < t; ++s) {
    const int64_t o = (n * t + s) * p + q;
    const float x = __ldg(ix + o);
    const float y = __ldg(iy + o);
    const float z = blend_logit(x, y, __ldg(conf + o), wmax, hmax);
    const float wt = __fdiv_rn(expf(__fsub_rn(z, zmax)), denom);
    wts[o] = wt;
    const dmv3d::Taps<true, kFast> taps(x, y, h, w);
    const float* img = imgs + (n * t + s) * c * plane;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) {
        float v[4];
        taps.load(img + ch * plane, v);
        const float val = taps.lerp(taps.col0(v), taps.col1(v));
        acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wt, val));
      }
    }
  }
  const int64_t pix = n * p + q;
  any_valid[pix] = anyv;
  const float m = __ldg(mask + pix);
  const float one_m = __fsub_rn(1.f, m);
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    if (ch < c) {
      const int64_t o = (n * c + ch) * p + q;
      multi[o] = acc[ch];
      view[o] = dot2(m, acc[ch], one_m, __ldg(rgb + o));
    }
  }
}

template <bool kFast>
void launch(const float* imgs, const float* ix, const float* iy,
            const float* conf, const float* mask, const float* rgb,
            float* view, float* multi, float* any_valid, float* wts, int n,
            int t, int c, int h, int w, int p, cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  multiflow_fwd_kernel<kFast><<<grid, kThreads, 0, stream>>>(
      imgs, ix, iy, conf, mask, rgb, view, multi, any_valid, wts, t, c, h, w,
      p);
}

}  // namespace

// imgs [n, t, c, h, w]; ix, iy, conf, wts [n, t, p]; mask, any_valid
// [n, p]; rgb, view, multi [n, c, p]; all f32, contiguous, on the device of
// `stream`; t >= 1, c <= 16. Returns cudaGetLastError().
extern "C" int dmv3d_multiflow_composite_fwd(
    const float* imgs, const float* ix, const float* iy, const float* conf,
    const float* mask, const float* rgb, float* view, float* multi,
    float* any_valid, float* wts, int n, int t, int c, int h, int w, int p,
    int fast, void* stream) {
  if (c > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && p > 0 && t > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast)
      launch<true>(imgs, ix, iy, conf, mask, rgb, view, multi, any_valid, wts,
                   n, t, c, h, w, p, s);
    else
      launch<false>(imgs, ix, iy, conf, mask, rgb, view, multi, any_valid,
                    wts, n, t, c, h, w, p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
