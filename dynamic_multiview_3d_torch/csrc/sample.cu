// Plain bilinear sampler at pixel coordinates.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _fwd_kernel (called through _call_fwd), the forward of sample_pixel_coords
// behind the public grid_sample and flow_warp; depth synthesis reaches it
// for its "warped" output.
//
// Per output pixel p of image n, with pixel coordinates (ix, iy):
//   border:   clamp (ix, iy) to the image, then sample bilinearly
//   zeros:    taps outside the image get weight 0
//   out[c]  = bilinear sample of channel c
// The taps, weights and rounding ("fast": bf16 image values and y-weights)
// are bilinear.cuh's, shared with every other kernel of the port: the
// result is bitwise that of sample_pixel_coords_plain in
// kernels/grid_sample.py. The backward is warp_composite_bwd.cu's
// no-composite launch.
//
// Bound on an H100 SXM: memory. Depth synthesis samples each example's
// last frame at the pixels of its K targets: at the c2 shape N = 16 frames
// of 3 x 128 x 128, P = K*H*W = 131,072 pixels each. Every pixel moves ix,
// iy and 3 outputs (20 B), the frames are read once (3.1 MB): 45 MB, about
// 13.5 us at 3.35 TB/s. The arithmetic (~40 flops/pixel) is two orders
// below the f32 rate.
//
// What keeps a gather kernel from that bound is the latency of its
// scattered tap loads and the sectors they move between L2 and the SMs.
// The design:
// - Channels-last frames (the model's NHWC frames as an [N,C,H,W] view;
//   the wrapper copies contiguous ones into that layout): one tap's C
//   values are contiguous, so a pixel's 4C loads touch 2-4 sectors where C
//   planes touch about 4C.
// - Three channels (the model's) are staged by the wrapper as [N, H, W, 4]
//   frames, one copy of 4.2 MB at c2: a tap is one aligned 16-byte load,
//   four per pixel where 12 scalar loads were. Measured on an H100 at the
//   c2 shape, staging copy included, it beat the unstaged channels-last
//   frames (PERF.md).
// - C is a template parameter, with one instantiation per C <= 4: every
//   channel's four taps are issued before the first is used, one round
//   trip to L2 per pixel after its coordinates. Larger C goes in groups of
//   4 channels (C = 0, the general instantiation).
// - One thread per output pixel, in blocks of consecutive pixels of one
//   image (grid.y): the coordinate reads and output writes are coalesced,
//   and in the model's layout a block's taps come from one frame, which
//   its K targets share, so they stay in L1/L2. No shared memory, no
//   atomics.

#include "bilinear.cuh"

namespace {

using dmv3d::Taps;

constexpr int kThreads = 256;
constexpr int kGroup = 4;     // channels per pass of the general instantiation

// one output channel from its four taps
template <bool kBorder, bool kFast>
__device__ __forceinline__ float sample(const Taps<kBorder, kFast>& taps,
                                        const float* v) {
  return taps.lerp(taps.col0(v), taps.col1(v));
}

// C = 3: frames staged as [N, H, W, 4]; other C > 0: C channels, one pass;
// C = 0: c channels in groups of kGroup
template <int C, bool kBorder, bool kFast>
__global__ void __launch_bounds__(kThreads) sample_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, float* __restrict__ out, int c, int h,
    int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const Taps<kBorder, kFast> taps(__ldg(ix + pix), __ldg(iy + pix), h, w);
  if constexpr (C > 0) {
    // a staged 3-channel frame holds 4 floats a pixel
    float v[C][4];
    taps.template load_channels<C>(img + b * h * w * (C == 3 ? 4 : C), v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      out[(b * C + ch) * p + q] = sample(taps, v[ch]);
  } else {
    const float* frame = img + b * h * w * c;
    for (int c0 = 0; c0 < c; c0 += kGroup) {
      // past the last channel, load the last one again (never stored)
      float v[kGroup][4];
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        taps.load(frame + min(c0 + k, c - 1), c, v[k]);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (c0 + k < c) out[(b * c + c0 + k) * p + q] = sample(taps, v[k]);
    }
  }
}

template <int C, bool kBorder, bool kFast>
void launch(const float* img, const float* ix, const float* iy, float* out,
            int n, int c, int h, int w, int p, cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  sample_fwd_kernel<C, kBorder, kFast><<<grid, kThreads, 0, stream>>>(
      img, ix, iy, out, c, h, w, p);
}

template <bool kBorder, bool kFast>
void dispatch(const float* img, const float* ix, const float* iy, float* out,
              int n, int c, int h, int w, int p, cudaStream_t s) {
  switch (c) {
    case 1: launch<1, kBorder, kFast>(img, ix, iy, out, n, c, h, w, p, s);
      break;
    case 2: launch<2, kBorder, kFast>(img, ix, iy, out, n, c, h, w, p, s);
      break;
    case 3: launch<3, kBorder, kFast>(img, ix, iy, out, n, c, h, w, p, s);
      break;
    case 4: launch<4, kBorder, kFast>(img, ix, iy, out, n, c, h, w, p, s);
      break;
    default: launch<0, kBorder, kFast>(img, ix, iy, out, n, c, h, w, p, s);
  }
}

}  // namespace

// img [n, c, h, w] channels-last (its memory is [n, h, w, c]), except for
// c = 3: [n, h, w, 4], 16-byte aligned, the fourth channel unused; ix, iy
// [n, p]; out [n, c, p]; all f32, on the device of `stream`, the others
// contiguous. Returns cudaGetLastError().
extern "C" int dmv3d_sample_fwd(const float* img, const float* ix,
                                const float* iy, float* out, int n, int c,
                                int h, int w, int p, int border, int fast,
                                void* stream) {
  if (n > 0 && p > 0 && c > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast)
        dispatch<true, true>(img, ix, iy, out, n, c, h, w, p, s);
      else
        dispatch<true, false>(img, ix, iy, out, n, c, h, w, p, s);
    } else {
      if (fast)
        dispatch<false, true>(img, ix, iy, out, n, c, h, w, p, s);
      else
        dispatch<false, false>(img, ix, iy, out, n, c, h, w, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
