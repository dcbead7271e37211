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
// coordinate clamped into the image; the model's) or zeros padding (a tap
// outside the image weighs 0), with bilinear.cuh's taps: the y-taps
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
// source) is two orders below the f32 rate.
//
// What keeps it from that bound is the traffic between L2 and the SMs,
// not device memory: the frames stay in L2, but every tap is a scattered
// gather, and a 32-byte sector moves for each tap that L1 does not hold.
// The design cuts that traffic and keeps many gathers in flight:
// - Channels-last frames: the model hands the NHWC frames as a
//   [N,T,C,H,W] view with channel stride 1, so one tap's C values are 12
//   contiguous bytes and the x0/x1 pair 24: a source's 12 loads touch 2-4
//   sectors, where planar frames (C planes) touch about 6. This is the one
//   layout the kernels take: the wrapper copies contiguous frames into it.
// - T is a compile-time constant (multiflow.cuh: one library per T and
//   padding, built at its first use): each source's ix, iy and conf are
//   read once, into registers, and the logits, exps and weights stay
//   there; the loops over the sources unroll, so all 3T coordinate loads,
//   and then the T sources' tap loads, are independent and in flight
//   together. (Re-read per loop, the coordinates would come from L2: one
//   pass's coordinates for 2,048 resident threads nearly fill an SM's L1.)
// - The channels go in passes of kGroup (3) over the sources' taps,
//   recomputed per pass from the coordinates; every channel's sum runs
//   over t in order, so the passes change nothing. C <= 3 (every model
//   path) has its own instantiations (kOnePass): one pass, straight-line
//   code, in which a source's coordinates die after its taps.
// One thread per target pixel of one example, in blocks of kFwdThreads
// (csrc/multiflow.cuh: 256, chosen by measurement), so every per-pixel
// read and write is coalesced; no shared memory, no atomics: every output
// is written once by one thread.

#include "bilinear.cuh"
#include "multiflow.cuh"

namespace {

using dmv3d::dot2;
using dmv3d::mf::kFwdThreads;
using dmv3d::mf::kGroup;

template <int T, bool kBorder, bool kFast, bool kOnePass>
__global__ void __launch_bounds__(kFwdThreads) multiflow_fwd_kernel(
    const float* __restrict__ imgs, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ conf,
    const float* __restrict__ mask, const float* __restrict__ rgb,
    float* __restrict__ view, float* __restrict__ multi,
    float* __restrict__ any_valid, float* __restrict__ wts, int c, int h,
    int w, int p) {
  const int q = blockIdx.x * kFwdThreads + threadIdx.x;  // pixel
  if (q >= p) return;
  const int64_t n = blockIdx.y;                           // example
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  const int64_t frame_size = static_cast<int64_t>(h) * w * c;
  const float* frames = imgs + n * T * frame_size;

  float x[T], y[T], wt[T], anyv;
  dmv3d::mf::blend<T>(ix, iy, conf, n * T * p + q, p, wmax, hmax, x, y, wt,
                      anyv);
#pragma unroll
  for (int s = 0; s < T; ++s) wts[(n * T + s) * p + q] = wt[s];
  any_valid[n * p + q] = anyv;
  const float m = __ldg(mask + n * p + q);
  const float one_m = __fsub_rn(1.f, m);

  // kOnePass (c <= kGroup, every model path): one pass, straight-line code
  for (int c0 = 0; c0 < (kOnePass ? 1 : c); c0 += kGroup) {
    float acc[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc[k] = 0.f;
#pragma unroll
    for (int s = 0; s < T; ++s) {
      const float* frame = frames + s * frame_size;
      const dmv3d::Taps<kBorder, kFast> taps(x[s], y[s], h, w);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        // past the last channel, load the last one again (no branch; never
        // stored)
        float v[4];
        taps.load(frame + min(c0 + k, c - 1), c, v);
        const float val = taps.lerp(taps.col0(v), taps.col1(v));
        acc[k] = __fadd_rn(acc[k], __fmul_rn(wt[s], val));
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (c0 + k < c) {
        const int64_t o = (n * c + c0 + k) * p + q;
        multi[o] = acc[k];
        view[o] = dot2(m, acc[k], one_m, __ldg(rgb + o));
      }
    }
  }
}

template <bool kFast, bool kOnePass>
void launch(const float* imgs, const float* ix, const float* iy,
            const float* conf, const float* mask, const float* rgb,
            float* view, float* multi, float* any_valid, float* wts, int n,
            int c, int h, int w, int p, cudaStream_t stream) {
  multiflow_fwd_kernel<dmv3d::mf::kSources, dmv3d::mf::kBorder, kFast,
                       kOnePass>
      <<<dmv3d::mf::grid(n, p, kFwdThreads), kFwdThreads, 0, stream>>>(
          imgs, ix, iy, conf, mask, rgb, view, multi, any_valid, wts, c, h,
          w, p);
}

}  // namespace

// imgs [n, t, c, h, w] channels-last (its memory is [n, t, h, w, c]); ix,
// iy, conf, wts [n, t, p]; mask, any_valid [n, p]; rgb, view, multi
// [n, c, p]; all f32, on the device of `stream`, the others contiguous;
// t the library's DMV3D_MF_T, c <= 16. Returns cudaGetLastError().
extern "C" int dmv3d_multiflow_composite_fwd(
    const float* imgs, const float* ix, const float* iy, const float* conf,
    const float* mask, const float* rgb, float* view, float* multi,
    float* any_valid, float* wts, int n, int t, int c, int h, int w, int p,
    int fast, void* stream) {
  if (c > dmv3d::mf::kMaxChannels || t != dmv3d::mf::kSources)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast) {
      if (c <= kGroup)
        launch<true, true>(imgs, ix, iy, conf, mask, rgb, view, multi,
                           any_valid, wts, n, c, h, w, p, s);
      else
        launch<true, false>(imgs, ix, iy, conf, mask, rgb, view, multi,
                            any_valid, wts, n, c, h, w, p, s);
    } else {
      if (c <= kGroup)
        launch<false, true>(imgs, ix, iy, conf, mask, rgb, view, multi,
                            any_valid, wts, n, c, h, w, p, s);
      else
        launch<false, false>(imgs, ix, iy, conf, mask, rgb, view, multi,
                             any_valid, wts, n, c, h, w, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
