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
// in (a few ulp between runs). The source frames are shared, as in the
// forward (reproject.cu: target image n reads frame n / K), so d_img holds
// one gradient per frame, summed over its K targets. The model's path never
// asks for it (the reprojected frame is data) and passes null: the kernel
// then has no atomics at all.
//
// Bound on an H100 SXM: memory. At the c2 shape (N = 128 target images of
// 3 x 128 x 128, P = 16,384, from 16 shared frames read once, 3.1 MB), the
// composite launch of depth synthesis's training step (d_view and d_geo,
// no d_img) reads depth, mask, 3 rgb, 3 d_view and 3 d_geo, and writes
// d_depth, d_mask and 3 d_rgb: 64 B/pixel, 137 MB, about 41 us at 3.35
// TB/s. The sample launch of the geometric side view reads depth and 3
// d_geo, and writes d_depth: 20 B/pixel, 45 MB, about 13.5 us. The
// arithmetic (~150 flops/pixel) is two orders below the f32 rate.
//
// What keeps a gather kernel from that bound is the latency of its loads
// and the sectors its scattered taps move between L2 and the SMs. The
// design:
// - C is a template parameter (one instantiation per C <= 4; C = 0, the
//   general one, loops over the channels): a pixel's camera scalars,
//   depth, mask and per-channel d_view, d_geo and rgb are all issued first,
//   then its 4C taps together, before any is used.
// - The camera's 12 scalars go to registers once (reproject.cuh Camera),
//   beside the other loads, with the forward's correspondence arithmetic.
// - Channels-last taps from the shared frame: a tap's C values are
//   contiguous, and a block's pixels read one frame, which its K targets
//   share, so its taps stay in L1/L2. Three channels are read staged as
//   [N/K, H, W, 4], as the forward reads them (the autograd ops keep the
//   frame the forward read): one 16-byte load per tap.
// One thread per target pixel, in blocks of 128 consecutive pixels of one
// row of one image (grid.z), so every per-pixel read and write is
// coalesced and (u, v) need no division (on an H100, 128 threads beat 256
// in both launches, PERF.md). No shared memory.

#include "bilinear.cuh"
#include "reproject.cuh"

namespace {

using dmv3d::Camera;
using dmv3d::Correspondence;
using dmv3d::Taps;

constexpr int kThreads = 128;
constexpr int kParams = 12;

// The chain rule of one channel: its four taps v, its cotangents (d_view
// dv where kComposite; d_geo dg0 where has_geo) and rgb r. Adds to the
// pixel's sums over the channels, writes d_rgb, scatters d_img.
template <bool kComposite, bool kFast>
__device__ __forceinline__ void channel_bwd(
    const Taps<false, kFast>& taps, const float* v, float dv, float dg0,
    bool has_geo, float r, float m, float one_m, float val, float* d_rgb,
    float* d_img, int stride, float& acc_x, float& acc_y, float& acc_m) {
  const float t0 = taps.col0(v);
  const float t1 = taps.col1(v);
  float dg;
  if (kComposite) {
    const float g = __fmul_rn(taps.lerp(t0, t1), val);
    dg = __fmul_rn(dv, m);
    if (has_geo) dg = __fadd_rn(dg, dg0);
    *d_rgb = __fmul_rn(dv, one_m);
    acc_m = __fadd_rn(acc_m, __fmul_rn(dv, __fsub_rn(g, r)));
  } else {
    dg = dg0;
  }
  const float ds = __fmul_rn(dg, val);
  acc_x = __fadd_rn(acc_x, __fmul_rn(taps.grad_x(t0, t1), ds));
  acc_y = __fadd_rn(acc_y, __fmul_rn(taps.grad_y(v), ds));
  if (d_img != nullptr) taps.scatter(d_img, stride, ds);
}

// C > 0: C channels, every load of the pixel in flight at once; C = 0: c
// channels, one at a time
template <int C, bool kComposite, bool kFast>
__global__ void __launch_bounds__(kThreads) reproject_bwd_kernel(
    const float* __restrict__ params, const float* __restrict__ depth,
    const float* __restrict__ img, const float* __restrict__ mask,
    const float* __restrict__ rgb, const float* __restrict__ d_view,
    const float* __restrict__ d_geo, float* __restrict__ d_img,
    float* __restrict__ d_depth, float* __restrict__ d_mask,
    float* __restrict__ d_rgb, int c, int h, int w, int k) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  const int v = blockIdx.y;
  if (u >= w) return;
  const int p = h * w;
  const int q = v * w + u;                             // pixel within image
  const int64_t b = blockIdx.z;                        // image
  const int64_t pix = b * p + q;
  const int ch_n = C > 0 ? C : c;
  // its source frame's first value: staged (4 floats a pixel) for C = 3;
  // d_img is channels-last
  const int64_t frame = (b / k) * p * (C == 3 ? 4 : ch_n);
  const int64_t grad_frame = (b / k) * p * ch_n;
  const Camera cam = Camera::load(params + b * kParams);
  const float d = __ldg(depth + pix);
  const float m = kComposite ? __ldg(mask + pix) : 0.f;
  const bool has_geo = d_geo != nullptr;     // the composite's may be null
  float acc_x = 0.f, acc_y = 0.f, acc_m = 0.f;
  if constexpr (C > 0) {
    float dv[C], dg[C], r[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int64_t o = (b * C + ch) * p + q;
      dv[ch] = kComposite ? __ldg(d_view + o) : 0.f;
      r[ch] = kComposite ? __ldg(rgb + o) : 0.f;
      dg[ch] = has_geo ? __ldg(d_geo + o) : 0.f;
    }
    const Correspondence cr(cam, d, u, v);
    const float val = cr.valid ? 1.f : 0.f;
    const Taps<false, kFast> taps(cr.x, cr.y, h, w);
    float t[C][4];
    taps.template load_channels<C>(img + frame, t);
    const float one_m = __fsub_rn(1.f, m);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      channel_bwd<kComposite>(taps, t[ch], dv[ch], dg[ch], has_geo, r[ch],
                              m, one_m, val, d_rgb + (b * C + ch) * p + q,
                              d_img == nullptr ? nullptr
                                               : d_img + grad_frame + ch,
                              C, acc_x, acc_y, acc_m);
    d_depth[pix] = cr.d_depth(acc_x, acc_y);
  } else {
    const Correspondence cr(cam, d, u, v);
    const float val = cr.valid ? 1.f : 0.f;
    const Taps<false, kFast> taps(cr.x, cr.y, h, w);
    const float one_m = __fsub_rn(1.f, m);
    for (int ch = 0; ch < c; ++ch) {
      const int64_t o = (b * c + ch) * p + q;
      float t[4];
      taps.load(img + frame + ch, c, t);
      channel_bwd<kComposite>(
          taps, t, kComposite ? __ldg(d_view + o) : 0.f,
          has_geo ? __ldg(d_geo + o) : 0.f, has_geo,
          kComposite ? __ldg(rgb + o) : 0.f, m, one_m, val, d_rgb + o,
          d_img == nullptr ? nullptr : d_img + grad_frame + ch, c, acc_x,
          acc_y, acc_m);
    }
    d_depth[pix] = cr.d_depth(acc_x, acc_y);
  }
  if (kComposite) d_mask[pix] = acc_m;
}

template <int C, bool kComposite, bool kFast>
void launch(const float* params, const float* depth, const float* img,
            const float* mask, const float* rgb, const float* d_view,
            const float* d_geo, float* d_img, float* d_depth, float* d_mask,
            float* d_rgb, int n, int c, int h, int w, int k,
            cudaStream_t stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, h, n);
  reproject_bwd_kernel<C, kComposite, kFast><<<grid, kThreads, 0, stream>>>(
      params, depth, img, mask, rgb, d_view, d_geo, d_img, d_depth, d_mask,
      d_rgb, c, h, w, k);
}

template <bool kComposite, bool kFast>
void dispatch(const float* params, const float* depth, const float* img,
              const float* mask, const float* rgb, const float* d_view,
              const float* d_geo, float* d_img, float* d_depth, float* d_mask,
              float* d_rgb, int n, int c, int h, int w, int k,
              cudaStream_t s) {
#define DMV3D_LAUNCH(C)                                                   \
  launch<C, kComposite, kFast>(params, depth, img, mask, rgb, d_view,     \
                               d_geo, d_img, d_depth, d_mask, d_rgb, n, c, \
                               h, w, k, s)
  switch (c) {
    case 1: DMV3D_LAUNCH(1); break;
    case 2: DMV3D_LAUNCH(2); break;
    case 3: DMV3D_LAUNCH(3); break;
    case 4: DMV3D_LAUNCH(4); break;
    default: DMV3D_LAUNCH(0);
  }
#undef DMV3D_LAUNCH
}

}  // namespace

// params [n, 12], 16-byte aligned; depth, mask, d_depth, d_mask [n, h*w];
// img, d_img [n / k, c, h, w], both channels-last (their memory is
// [n / k, h, w, c]), except img for c = 3: [n / k, h, w, 4], 16-byte
// aligned, the fourth channel unused;
// rgb, d_view, d_geo, d_rgb [n, c, h*w]; all f32, on the device of
// `stream`, the others contiguous; k divides n. A null mask is the sample
// launch: mask, rgb, d_view, d_mask and d_rgb are null and d_geo is
// required. In the composite launch d_geo may be null (zero). d_img may be
// null (not computed), else it must hold zeros. Returns cudaGetLastError().
extern "C" int dmv3d_reproject_bwd(const float* params, const float* depth,
                                   const float* img, const float* mask,
                                   const float* rgb, const float* d_view,
                                   const float* d_geo, float* d_img,
                                   float* d_depth, float* d_mask,
                                   float* d_rgb, int n, int c, int h, int w,
                                   int k, int fast, void* stream) {
  if (n > 0 && c > 0 && h > 0 && w > 0 && k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mask != nullptr) {
      if (fast)
        dispatch<true, true>(params, depth, img, mask, rgb, d_view, d_geo,
                             d_img, d_depth, d_mask, d_rgb, n, c, h, w, k, s);
      else
        dispatch<true, false>(params, depth, img, mask, rgb, d_view, d_geo,
                              d_img, d_depth, d_mask, d_rgb, n, c, h, w, k,
                              s);
    } else {
      if (fast)
        dispatch<false, true>(params, depth, img, mask, rgb, d_view, d_geo,
                              d_img, d_depth, d_mask, d_rgb, n, c, h, w, k,
                              s);
      else
        dispatch<false, false>(params, depth, img, mask, rgb, d_view, d_geo,
                               d_img, d_depth, d_mask, d_rgb, n, c, h, w, k,
                               s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
