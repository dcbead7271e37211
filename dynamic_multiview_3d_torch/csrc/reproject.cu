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
// weights and "fast" rounding are bilinear.cuh's: the outputs equal those
// of the plain versions in kernels/reproject.py, value for value (|a - b|
// = 0). They are bitwise equal too, except that a zero may differ in sign:
// the kernels skip the loads of taps that zeros padding gives no weight and
// take 0 for them (bilinear.cuh Taps::weighted). A frame value that is not
// finite under such a tap therefore gives 0 here where the plain version,
// which multiplies it by its weight 0, gives NaN.
//
// The source frames are one per example, shared by its K targets: target
// image n reads frame n / K (K = 1: one frame per target). Three channels
// are read staged as [N/K, H, W, 4] (kernels/_build.py stage: the model
// stages its last frame once per forward and hands that view to every
// single-source kernel, so the wrappers copy nothing); other C
// channels-last (the NHWC frames as an [N/K, C, H, W] view).
//
// Bound on an H100 SXM: memory. At the c2 shape (N = 128 target images of
// 3 x 128 x 128, P = 16,384 pixels each, from 16 shared frames read once,
// 3.1 MB) the sample entry moves depth, 3 geo and valid per pixel: 20
// B/pixel, 45 MB, about 13.5 us at 3.35 TB/s; the composite entry adds
// mask, 3 rgb and 3 view: 48 B/pixel, 104 MB, about 31 us. The
// arithmetic (~60 flops/pixel) is two orders below the f32 rate.
//
// What keeps a gather from that bound is the latency of its dependent
// loads (depth, then the taps it places) and the sectors its scattered taps
// move from L2. The design:
// - C is a template parameter, one instantiation per C <= 4 and a general
//   one (C = 0) in groups of 4 channels: a pixel's depth, mask and rgb are
//   issued together, then all its taps, one round trip each; no runtime
//   loop over channels.
// - Three channels staged: a tap is one aligned 16-byte load, four per
//   pixel where twelve scalar loads were.
// - Zeros padding weighs out-of-image taps 0: their loads are not issued
//   (predicated), nor any of a pixel that is not valid. With random depths
//   at c2 about half the taps are off the image.
// - Blocks of 32 x 8 pixels of one image (grid.z): a warp is 32
//   consecutive pixels of a row, so every per-pixel read and write is
//   coalesced, and (u, v) come from the block and thread indices, with no
//   division. The image's 12 camera scalars are three 16-byte loads, the
//   same addresses across the block (broadcast).
// - The per-pixel reads and writes, each touched once, carry evict-first
//   hints (__ldcs, __stcs), as #1's do (warp_composite.cu), so the streams
//   push the frames out of L2 less.
// The TPU's formulation (tent-weight matmuls over a VMEM-resident image,
// pixel blocks from a planner) does not carry over: a gather from L1/L2 is
// the natural CUDA form of the same sample. No shared memory, no atomics.

#include "bilinear.cuh"
#include "reproject.cuh"

namespace {

using dmv3d::Camera;
using dmv3d::Correspondence;
using dmv3d::Taps;
using dmv3d::dot2;

constexpr int kBlockX = 32;   // a warp: 32 consecutive pixels of a row
constexpr int kBlockY = 8;    // rows of a block
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kParams = 12;
constexpr int kGroup = 4;     // channels per pass of the general instantiation

struct Args {
  const float *params, *depth, *img, *mask, *rgb;
  float *view, *geo, *valid;
  int n, c, h, w, k;
};

// one output channel from its four taps t: geo, and view where composite
template <bool kComposite, bool kFast>
__device__ __forceinline__ void store(const Taps<false, kFast>& taps,
                                      const float* t, float val, float m,
                                      float r, float* geo, float* view) {
  const float g = __fmul_rn(taps.lerp(taps.col0(t), taps.col1(t)), val);
  __stcs(geo, g);
  if (kComposite) __stcs(view, dot2(m, g, __fsub_rn(1.f, m), r));
}

// One thread per target pixel. C = 3: frames staged as [N/K, H, W, 4];
// other C > 0: C channels-last, one pass; C = 0: c channels in groups of
// kGroup. Without kComposite, mask, rgb and view are not read.
template <int C, bool kComposite, bool kFast>
__device__ __forceinline__ void reproject_pixel(const Args& a) {
  const int u = blockIdx.x * kBlockX + threadIdx.x;
  const int v = blockIdx.y * kBlockY + threadIdx.y;
  if (u >= a.w || v >= a.h) return;
  const int64_t b = blockIdx.z;                        // target image
  const int64_t p = static_cast<int64_t>(a.h) * a.w;
  const int64_t q = static_cast<int64_t>(v) * a.w + u;  // pixel within image
  const int64_t pix = b * p + q;
  const int c = C > 0 ? C : a.c;
  const float* frame = a.img + (b / a.k) * p * (C == 3 ? 4 : c);
  const float d = __ldcs(a.depth + pix);
  const float m = kComposite ? __ldcs(a.mask + pix) : 0.f;
  if constexpr (C > 0) {
    float r[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      r[ch] = kComposite ? __ldcs(a.rgb + (b * C + ch) * p + q) : 0.f;
    const Correspondence cr(Camera::load(a.params + b * kParams), d, u, v);
    const Taps<false, kFast> taps(cr.x, cr.y, a.h, a.w);
    float t[C][4];
    taps.template load_channels<C, true>(frame, t);
    const float val = cr.valid ? 1.f : 0.f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int64_t o = (b * C + ch) * p + q;
      store<kComposite>(taps, t[ch], val, m, r[ch], a.geo + o, a.view + o);
    }
    __stcs(a.valid + pix, val);
  } else {
    const Correspondence cr(Camera::load(a.params + b * kParams), d, u, v);
    const Taps<false, kFast> taps(cr.x, cr.y, a.h, a.w);
    const float val = cr.valid ? 1.f : 0.f;
    for (int c0 = 0; c0 < c; c0 += kGroup) {
      // past the last channel, load the last one again (never stored)
      float r[kGroup], t[kGroup][4];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int ch = min(c0 + g, c - 1);
        r[g] = kComposite ? __ldcs(a.rgb + (b * c + ch) * p + q) : 0.f;
        taps.load_weighted(frame + ch, c, t[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g >= c) break;
        const int64_t o = (b * c + c0 + g) * p + q;
        store<kComposite>(taps, t[g], val, m, r[g], a.geo + o, a.view + o);
      }
    }
    __stcs(a.valid + pix, val);
  }
}

// two kernels, so that a profiler tells the entries apart by name
template <int C, bool kFast>
__global__ void __launch_bounds__(kThreads)
    reproject_sample_kernel(const Args a) {
  reproject_pixel<C, false, kFast>(a);
}

template <int C, bool kFast>
__global__ void __launch_bounds__(kThreads)
    reproject_composite_kernel(const Args a) {
  reproject_pixel<C, true, kFast>(a);
}

template <int C, bool kFast>
void launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.w + kBlockX - 1) / kBlockX,
                  (a.h + kBlockY - 1) / kBlockY, a.n);
  const dim3 block(kBlockX, kBlockY);
  if (a.mask != nullptr)
    reproject_composite_kernel<C, kFast><<<grid, block, 0, s>>>(a);
  else
    reproject_sample_kernel<C, kFast><<<grid, block, 0, s>>>(a);
}

template <bool kFast>
void dispatch(const Args& a, cudaStream_t s) {
  switch (a.c) {
    case 1: launch<1, kFast>(a, s); break;
    case 2: launch<2, kFast>(a, s); break;
    case 3: launch<3, kFast>(a, s); break;
    case 4: launch<4, kFast>(a, s); break;
    default: launch<0, kFast>(a, s);
  }
}

int run(const Args& a, int fast, void* stream) {
  if (a.n > 0 && a.c > 0 && a.h > 0 && a.w > 0 && a.k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast) dispatch<true>(a, s);
    else dispatch<false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params [n, 12], 16-byte aligned; depth, valid [n, h*w]; img [n / k, c,
// h, w] channels-last (its memory is [n / k, h, w, c]), except for c = 3:
// [n / k, h, w, 4], 16-byte aligned, the fourth channel unused; geo [n, c,
// h*w]; all f32, on the device of `stream`, the others contiguous; k
// divides n. Returns cudaGetLastError().
extern "C" int dmv3d_reproject_sample_fwd(const float* params,
                                          const float* depth,
                                          const float* img, float* geo,
                                          float* valid, int n, int c, int h,
                                          int w, int k, int fast,
                                          void* stream) {
  return run(Args{params, depth, img, nullptr, nullptr, nullptr, geo, valid,
                  n, c, h, w, k},
             fast, stream);
}

// As dmv3d_reproject_sample_fwd, plus mask [n, h*w] (not null) and rgb,
// view [n, c, h*w].
extern "C" int dmv3d_reproject_composite_fwd(
    const float* params, const float* depth, const float* img,
    const float* mask, const float* rgb, float* view, float* geo,
    float* valid, int n, int c, int h, int w, int k, int fast,
    void* stream) {
  return run(Args{params, depth, img, mask, rgb, view, geo, valid, n, c, h,
                  w, k},
             fast, stream);
}
