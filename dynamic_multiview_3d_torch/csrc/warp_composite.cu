// Fused appearance-flow warp + mask composite + in-bounds validity.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _fwd_composite_kernel (called through _call_fwd_composite), the forward of
// flow_warp_composite on the model's flow-synthesis path.
//
// Per output pixel p of target image n, with pixel coordinates (ix, iy):
//   valid     = 0 <= ix <= W-1 and 0 <= iy <= H-1   (unclamped coordinates)
//   border:     clamp (ix, iy) to the image, then sample bilinearly
//   zeros:      taps outside the image get weight 0
//   warped[c] = bilinear sample of channel c of source frame n / K
//   view[c]   = mask * warped[c] + (1 - mask) * rgb[c]
// The taps, weights and rounding are bilinear.cuh's (shared with the
// backward and the other gather kernels): the result is bitwise that of the
// plain PyTorch version in kernels/grid_sample.py, which does the same
// operations one by one.
//
// The source frames are shared: flow synthesis warps each example's last
// frame into its K targets, so N targets read N / K frames, target n frame
// n / K (K = 1: one image per target, the public NHWC op's contract).
//
// Bound on an H100 SXM: memory. At the c2 shape (N = 128 targets of 3 x 128
// x 128, P = 16,384 pixels each, 2.10 M pixels, from 16 frames) every pixel
// reads ix, iy, mask and 3 rgb and writes 3 view, 3 warped and valid (52
// B), and the frames are read once (3.1 MB): 112,197,632 B, 33.49 us at
// 3.35 TB/s. The arithmetic (~50 flops/pixel) is two orders below the f32
// rate.
//
// What keeps a gather kernel from that bound is the latency of its
// scattered tap loads and the sectors they move between L2 and the SMs.
// The design (that of sample.cu):
// - Channels-last frames (the model's NHWC frames as an [N/K,C,H,W] view;
//   the wrapper copies contiguous ones into that layout): one tap's C
//   values are contiguous.
// - Three channels are staged by the wrapper as [N/K, H, W, 4], one copy
//   of 4.2 MB at c2, which the autograd op keeps for the backward: a tap is
//   one aligned 16-byte load.
// - C is a template parameter, one instantiation per C <= 4: a pixel's
//   mask and rgb loads and all its tap loads are issued before the first is
//   used. Larger C goes in groups of 4 channels (C = 0, the general
//   instantiation).
// - One thread per target pixel, in blocks of consecutive pixels of one
//   target (grid.y): the reads of ix, iy, mask and each rgb plane and the
//   writes of each output plane are coalesced, and a block's taps come from
//   one frame, which its K targets share, so they stay in L1/L2. No shared
//   memory, no atomics: every output is written once by one thread.
// - Those per-pixel reads and writes, each touched once, carry evict-first
//   hints (__ldcs, __stcs), so the 110 MB that stream through L2 push the
//   4.2 MB of staged frames out of it less: on an H100 at the c2 shape the
//   kernel went from 56.0 to 53.5 us with its staging copy (PERF.md). The
//   backward measured no gain from them and keeps plain loads.

#include "bilinear.cuh"

namespace {

using dmv3d::Taps;
using dmv3d::dot2;

constexpr int kThreads = 256;
constexpr int kGroup = 4;     // channels per pass of the general instantiation

// warped and view of one channel from its four taps v and its rgb r
template <bool kBorder, bool kFast>
__device__ __forceinline__ void composite(const Taps<kBorder, kFast>& taps,
                                          const float* v, float r, float m,
                                          float one_m, float* warped,
                                          float* view) {
  const float s = taps.lerp(taps.col0(v), taps.col1(v));
  __stcs(warped, s);
  __stcs(view, dot2(m, s, one_m, r));
}

// C = 3: frames staged as [N/K, H, W, 4]; other C > 0: C channels, one
// pass; C = 0: c channels in groups of kGroup
template <int C, bool kBorder, bool kFast>
__global__ void __launch_bounds__(kThreads) warp_composite_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ mask,
    const float* __restrict__ rgb, float* __restrict__ view,
    float* __restrict__ warped, float* __restrict__ valid, int c, int h,
    int w, int p, int k) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within target
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // target image
  const int64_t pix = b * p + q;
  const int64_t frame = (b / k) * h * w;               // its frame's pixel 0
  const float x = __ldcs(ix + pix);
  const float y = __ldcs(iy + pix);
  const float m = __ldcs(mask + pix);
  const float one_m = __fsub_rn(1.f, m);
  if constexpr (C > 0) {
    float r[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      r[ch] = __ldcs(rgb + (b * C + ch) * p + q);
    const Taps<kBorder, kFast> taps(x, y, h, w);
    float v[C][4];
    taps.template load_channels<C>(img + frame * (C == 3 ? 4 : C), v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int64_t o = (b * C + ch) * p + q;
      composite(taps, v[ch], r[ch], m, one_m, warped + o, view + o);
    }
  } else {
    const Taps<kBorder, kFast> taps(x, y, h, w);
    const float* src = img + frame * c;
    for (int c0 = 0; c0 < c; c0 += kGroup) {
      // past the last channel, load the last one again (never stored)
      float r[kGroup], v[kGroup][4];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int ch = min(c0 + g, c - 1);
        r[g] = __ldcs(rgb + (b * c + ch) * p + q);
        taps.load(src + ch, c, v[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g >= c) break;
        const int64_t o = (b * c + c0 + g) * p + q;
        composite(taps, v[g], r[g], m, one_m, warped + o, view + o);
      }
    }
  }
  __stcs(valid + pix, dmv3d::in_bounds(x, y, static_cast<float>(w - 1),
                                       static_cast<float>(h - 1)));
}

struct Args {
  const float *img, *ix, *iy, *mask, *rgb;
  float *view, *warped, *valid;
  int n, c, h, w, p, k;
};

template <int C, bool kBorder, bool kFast>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.p + kThreads - 1) / kThreads, a.n);
  warp_composite_fwd_kernel<C, kBorder, kFast><<<grid, kThreads, 0, stream>>>(
      a.img, a.ix, a.iy, a.mask, a.rgb, a.view, a.warped, a.valid, a.c, a.h,
      a.w, a.p, a.k);
}

template <bool kBorder, bool kFast>
void dispatch(const Args& a, cudaStream_t s) {
  switch (a.c) {
    case 1: launch<1, kBorder, kFast>(a, s); break;
    case 2: launch<2, kBorder, kFast>(a, s); break;
    case 3: launch<3, kBorder, kFast>(a, s); break;
    case 4: launch<4, kBorder, kFast>(a, s); break;
    default: launch<0, kBorder, kFast>(a, s);
  }
}

}  // namespace

// img [n / k, c, h, w] channels-last (its memory is [n / k, h, w, c]),
// except for c = 3: [n / k, h, w, 4], 16-byte aligned, the fourth channel
// unused; target image b reads frame b / k. ix, iy, mask, valid [n, p];
// rgb, view, warped [n, c, p]; all f32, on the device of `stream`, the
// others contiguous; k divides n. Returns cudaGetLastError().
extern "C" int dmv3d_warp_composite_fwd(const float* img, const float* ix,
                                        const float* iy, const float* mask,
                                        const float* rgb, float* view,
                                        float* warped, float* valid, int n,
                                        int c, int h, int w, int p, int k,
                                        int border, int fast, void* stream) {
  if (n > 0 && c > 0 && p > 0 && k > 0) {
    const Args a{img, ix, iy, mask, rgb, view, warped, valid,
                 n, c, h, w, p, k};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast) dispatch<true, true>(a, s);
      else dispatch<true, false>(a, s);
    } else {
      if (fast) dispatch<false, true>(a, s);
      else dispatch<false, false>(a, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
