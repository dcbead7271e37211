// Backward of the fused appearance-flow warp + mask composite.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _bwd_kernel (called through _call_bwd) together with the chain rule of
// _wc_bwd around it: the backward of flow_warp_composite on the model's
// training path. The forward is warp_composite.cu.
//
// Per output pixel p of target image n, with cotangents d_view[c] and
// d_warped[c] (optional: null means zero), recomputing the forward's taps
// in source frame n / K:
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
// Depth synthesis launches it on one frame per example (K = 1) sampled at
// its K targets' pixels (P = K*H*W).
//
// d_img is the one output several pixels write: one array per frame,
// channels-last like the frames, zeroed by the caller and accumulated with
// atomicAdd over the frame's K targets, so its value depends on the order
// the atomics land in (a few ulp between runs). The model's path never asks
// for it (the warped frame is data); the caller passes null then and the
// kernel has no atomics at all.
//
// Bound on an H100 SXM: memory. At the c2 training shape (N = 128 targets
// of 3 x 128 x 128, P = 16,384, 2.10 M pixels, from 16 frames) without
// d_img and d_warped, every pixel reads ix, iy, mask, 3 rgb and 3 d_view
// and writes d_ix, d_iy, d_mask and 3 d_rgb (60 B), and the frames are
// read once (3.1 MB): 128,974,848 B, 38.50 us at 3.35 TB/s. The
// no-composite launch at the c2d shape (16 frames sampled at K*H*W =
// 131,072 pixels each, no d_img) reads ix, iy and 3 d_warped and writes
// d_ix, d_iy (28 B a pixel) and reads the frames once: 61,865,984 B,
// 18.47 us. The arithmetic (~130 flops/pixel) is two orders below the f32
// rate.
//
// Design, as the forward's (warp_composite.cu): channels-last frames, 3
// channels staged as [N/K, H, W, 4] (one 16-byte load per tap); C a
// template parameter (one instantiation per C <= 4; C = 0, the general
// one, goes in groups of 4 channels), so a pixel's d_view, d_warped and rgb
// loads and all its tap loads are issued before the first is used; one
// thread per target pixel, in blocks of consecutive pixels of one target,
// so every per-pixel read and write is coalesced and the tap gathers come
// from one shared frame in L1/L2. No shared memory.

#include "bilinear.cuh"

namespace {

using dmv3d::Taps;

constexpr int kThreads = 256;
constexpr int kGroup = 4;     // channels per pass of the general instantiation

// The chain rule of one channel: its four taps v, its cotangents dv
// (d_view, where kComposite) and dw (d_warped, where has_warped) and its
// rgb r. Adds to the pixel's sums over the channels, writes d_rgb, scatters
// d_img (`stride` floats between its pixels).
template <bool kComposite, bool kBorder, bool kFast>
__device__ __forceinline__ void channel_bwd(
    const Taps<kBorder, kFast>& taps, const float* v, float dv, float dw,
    bool has_warped, float r, float m, float one_m, float* d_rgb,
    float* d_img, int stride, float& acc_x, float& acc_y, float& acc_m) {
  const float t0 = taps.col0(v);
  const float t1 = taps.col1(v);
  float ds;
  if (kComposite) {
    const float s = taps.lerp(t0, t1);
    ds = __fmul_rn(dv, m);
    if (has_warped) ds = __fadd_rn(ds, dw);
    *d_rgb = __fmul_rn(dv, one_m);
    acc_m = __fadd_rn(acc_m, __fmul_rn(dv, __fsub_rn(s, r)));
  } else {
    ds = dw;
  }
  acc_x = __fadd_rn(acc_x, __fmul_rn(taps.grad_x(t0, t1), ds));
  acc_y = __fadd_rn(acc_y, __fmul_rn(taps.grad_y(v), ds));
  if (d_img != nullptr) taps.scatter(d_img, stride, ds);
}

// C = 3: frames staged as [N/K, H, W, 4]; other C > 0: C channels, one
// pass; C = 0: c channels in groups of kGroup
template <int C, bool kBorder, bool kFast, bool kComposite>
__global__ void __launch_bounds__(kThreads) warp_composite_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ mask,
    const float* __restrict__ rgb, const float* __restrict__ d_view,
    const float* __restrict__ d_warped, float* __restrict__ d_img,
    float* __restrict__ d_ix, float* __restrict__ d_iy,
    float* __restrict__ d_mask, float* __restrict__ d_rgb, int c, int h,
    int w, int p, int k) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within target
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // target image
  const int64_t pix = b * p + q;
  const int64_t frame = (b / k) * h * w;               // its frame's pixel 0
  const int ch_n = C > 0 ? C : c;
  float* const d_frame = d_img == nullptr ? nullptr : d_img + frame * ch_n;
  const float x = __ldg(ix + pix);
  const float y = __ldg(iy + pix);
  const float m = kComposite ? __ldg(mask + pix) : 0.f;
  const float one_m = __fsub_rn(1.f, m);
  const bool has_warped = d_warped != nullptr;  // the composite's may be null
  float acc_x = 0.f, acc_y = 0.f, acc_m = 0.f;
  if constexpr (C > 0) {
    float dv[C], dw[C], r[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int64_t o = (b * C + ch) * p + q;
      dv[ch] = kComposite ? __ldg(d_view + o) : 0.f;
      r[ch] = kComposite ? __ldg(rgb + o) : 0.f;
      dw[ch] = has_warped ? __ldg(d_warped + o) : 0.f;
    }
    const Taps<kBorder, kFast> taps(x, y, h, w);
    float v[C][4];
    taps.template load_channels<C>(img + frame * (C == 3 ? 4 : C), v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      channel_bwd<kComposite>(
          taps, v[ch], dv[ch], dw[ch], has_warped, r[ch], m, one_m,
          d_rgb + (b * C + ch) * p + q,
          d_frame == nullptr ? nullptr : d_frame + ch, C, acc_x, acc_y,
          acc_m);
  } else {
    const Taps<kBorder, kFast> taps(x, y, h, w);
    const float* src = img + frame * c;
    for (int c0 = 0; c0 < c; c0 += kGroup) {
      // past the last channel, load the last one again (never used)
      float dv[kGroup], dw[kGroup], r[kGroup], v[kGroup][4];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int ch = min(c0 + g, c - 1);
        const int64_t o = (b * c + ch) * p + q;
        dv[g] = kComposite ? __ldg(d_view + o) : 0.f;
        r[g] = kComposite ? __ldg(rgb + o) : 0.f;
        dw[g] = has_warped ? __ldg(d_warped + o) : 0.f;
        taps.load(src + ch, c, v[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g >= c) break;
        channel_bwd<kComposite>(
            taps, v[g], dv[g], dw[g], has_warped, r[g], m, one_m,
            d_rgb + (b * c + c0 + g) * p + q,
            d_frame == nullptr ? nullptr : d_frame + c0 + g, c, acc_x, acc_y,
            acc_m);
      }
    }
  }
  d_ix[pix] = acc_x;
  d_iy[pix] = acc_y;
  if (kComposite) d_mask[pix] = acc_m;
}

struct Args {
  const float *img, *ix, *iy, *mask, *rgb, *d_view, *d_warped;
  float *d_img, *d_ix, *d_iy, *d_mask, *d_rgb;
  int n, c, h, w, p, k;
};

template <int C, bool kBorder, bool kFast, bool kComposite>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.p + kThreads - 1) / kThreads, a.n);
  warp_composite_bwd_kernel<C, kBorder, kFast, kComposite>
      <<<grid, kThreads, 0, stream>>>(a.img, a.ix, a.iy, a.mask, a.rgb,
                                      a.d_view, a.d_warped, a.d_img, a.d_ix,
                                      a.d_iy, a.d_mask, a.d_rgb, a.c, a.h,
                                      a.w, a.p, a.k);
}

template <bool kBorder, bool kFast, bool kComposite>
void dispatch(const Args& a, cudaStream_t s) {
  switch (a.c) {
    case 1: launch<1, kBorder, kFast, kComposite>(a, s); break;
    case 2: launch<2, kBorder, kFast, kComposite>(a, s); break;
    case 3: launch<3, kBorder, kFast, kComposite>(a, s); break;
    case 4: launch<4, kBorder, kFast, kComposite>(a, s); break;
    default: launch<0, kBorder, kFast, kComposite>(a, s);
  }
}

template <bool kBorder, bool kFast>
void dispatch_composite(const Args& a, cudaStream_t s) {
  if (a.mask != nullptr) dispatch<kBorder, kFast, true>(a, s);
  else dispatch<kBorder, kFast, false>(a, s);
}

}  // namespace

// img [n / k, c, h, w] channels-last (its memory is [n / k, h, w, c]),
// except for c = 3: [n / k, h, w, 4], 16-byte aligned, the fourth channel
// unused; target image b reads frame b / k. d_img [n / k, c, h, w]
// channels-last, one gradient per frame summed over its k targets; ix, iy,
// mask, d_ix, d_iy, d_mask [n, p]; rgb, d_view, d_warped, d_rgb [n, c, p];
// all f32, on the device of `stream`, the others contiguous; k divides n.
// d_warped may be null (zero); d_img may be null (not computed), else it
// must hold zeros. A null mask is the no-composite launch: mask, rgb,
// d_view, d_mask and d_rgb are null and d_warped is the sample's
// cotangent. Returns cudaGetLastError().
extern "C" int dmv3d_warp_composite_bwd(
    const float* img, const float* ix, const float* iy, const float* mask,
    const float* rgb, const float* d_view, const float* d_warped,
    float* d_img, float* d_ix, float* d_iy, float* d_mask, float* d_rgb,
    int n, int c, int h, int w, int p, int k, int border, int fast,
    void* stream) {
  if (n > 0 && c > 0 && p > 0 && k > 0) {
    const Args a{img, ix, iy, mask, rgb, d_view, d_warped, d_img, d_ix, d_iy,
                 d_mask, d_rgb, n, c, h, w, p, k};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast) dispatch_composite<true, true>(a, s);
      else dispatch_composite<true, false>(a, s);
    } else {
      if (fast) dispatch_composite<false, true>(a, s);
      else dispatch_composite<false, false>(a, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
