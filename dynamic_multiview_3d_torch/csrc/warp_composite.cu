// Fused appearance-flow warp + mask composite + in-bounds validity.
//
// Replaces the TPU kernel dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py
// _fwd_composite_kernel (called through _call_fwd_composite), the forward of
// flow_warp_composite on the model's flow-synthesis path.
//
// Per output pixel p of image n, with pixel coordinates (ix, iy):
//   valid     = 0 <= ix <= W-1 and 0 <= iy <= H-1   (unclamped coordinates)
//   border:     clamp (ix, iy) to the image, then sample bilinearly
//   zeros:      taps outside the image get weight 0
//   warped[c] = bilinear sample of channel c
//   view[c]   = mask * warped[c] + (1 - mask) * rgb[c]
// The TPU kernel's tent weights relu(1 - |h - c|) are exactly the two
// floor / floor+1 taps used here. The y-taps are combined first, then the
// x-taps, in the TPU kernel's order. precision "fast" rounds the image
// values and the y-tap weights to bf16 before the products (what the TPU's
// single-pass bf16 matmul does); x-weights and sums stay f32. Every
// product and sum is written with the _rn intrinsics so nvcc contracts
// nothing into an FMA: the result is bitwise that of the plain PyTorch
// version in kernels/grid_sample.py, which does the same operations one by
// one.
//
// Bound on an H100 SXM: memory. At the c2 serving shape (N = 128 images of
// 3 x 128 x 128, P = 16,384 pixels each, 2.10 M pixels) every pixel moves
// 16 f32 values — ix, iy, mask, 3 rgb, 3 source taps (the image read once),
// 3 view, 3 warped, 1 valid — 64 B/pixel, 134 MB in all: about 40 us at
// 3.35 TB/s. The arithmetic (~40 flops/pixel) is two orders below the f32
// rate.
//
// Design: one thread per output pixel, looping over the channels. Threads
// of a block cover consecutive pixels of one image, so the reads of ix, iy,
// mask and each rgb plane and the writes of each output plane are
// coalesced. The four taps per channel are gathers from one image, which
// stays in L1/L2 (196 KB per image at c2). No shared memory, no atomics:
// every output is written once by one thread, so the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBorder, bool kFast>
__global__ void __launch_bounds__(kThreads) warp_composite_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ ix,
    const float* __restrict__ iy, const float* __restrict__ mask,
    const float* __restrict__ rgb, float* __restrict__ view,
    float* __restrict__ warped, float* __restrict__ valid, int c, int h,
    int w, int p) {
  const int q = blockIdx.x * kThreads + threadIdx.x;  // pixel within image
  if (q >= p) return;
  const int64_t b = blockIdx.y;                        // image
  const int64_t pix = b * p + q;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);

  float x = __ldg(ix + pix);
  float y = __ldg(iy + pix);
  const float m = __ldg(mask + pix);
  valid[pix] = (x >= 0.f && x <= wmax && y >= 0.f && y <= hmax) ? 1.f : 0.f;
  if (kBorder) {
    x = fminf(fmaxf(x, 0.f), wmax);
    y = fminf(fmaxf(y, 0.f), hmax);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx1 = __fsub_rn(x, x0f);
  const float wy1f = __fsub_rn(y, y0f);
  float wx0 = __fsub_rn(1.f, wx1);
  float wx1m = wx1;
  float wy0 = __fsub_rn(1.f, wy1f);
  float wy1 = wy1f;
  if (!kBorder) {  // zeros padding: out-of-range taps have no weight
    if (x0f < 0.f || x0f > wmax) wx0 = 0.f;
    if (x0f + 1.f < 0.f || x0f + 1.f > wmax) wx1m = 0.f;
    if (y0f < 0.f || y0f > hmax) wy0 = 0.f;
    if (y0f + 1.f < 0.f || y0f + 1.f > hmax) wy1 = 0.f;
  }
  if (kFast) {
    wy0 = round_bf16(wy0);
    wy1 = round_bf16(wy1);
  }
  // clamped tap indices (a tap outside the image has weight 0 or, under
  // border padding, sits at the edge already)
  const int xa = static_cast<int>(fminf(fmaxf(x0f, 0.f), wmax));
  const int xb = static_cast<int>(fminf(fmaxf(x0f + 1.f, 0.f), wmax));
  const int ya = static_cast<int>(fminf(fmaxf(y0f, 0.f), hmax));
  const int yb = static_cast<int>(fminf(fmaxf(y0f + 1.f, 0.f), hmax));
  const float one_m = __fsub_rn(1.f, m);
  const int64_t plane = static_cast<int64_t>(h) * w;

  for (int ch = 0; ch < c; ++ch) {
    const float* src = img + (b * c + ch) * plane;
    float v00 = __ldg(src + ya * w + xa);
    float v10 = __ldg(src + yb * w + xa);
    float v01 = __ldg(src + ya * w + xb);
    float v11 = __ldg(src + yb * w + xb);
    if (kFast) {
      v00 = round_bf16(v00);
      v10 = round_bf16(v10);
      v01 = round_bf16(v01);
      v11 = round_bf16(v11);
    }
    const float t0 = __fadd_rn(__fmul_rn(wy0, v00), __fmul_rn(wy1, v10));
    const float t1 = __fadd_rn(__fmul_rn(wy0, v01), __fmul_rn(wy1, v11));
    const float s = __fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1m, t1));
    const int64_t o = (b * c + ch) * p + q;
    warped[o] = s;
    view[o] = __fadd_rn(__fmul_rn(m, s), __fmul_rn(one_m, __ldg(rgb + o)));
  }
}

template <bool kBorder, bool kFast>
void launch(const float* img, const float* ix, const float* iy,
            const float* mask, const float* rgb, float* view, float* warped,
            float* valid, int n, int c, int h, int w, int p,
            cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  warp_composite_fwd_kernel<kBorder, kFast><<<grid, kThreads, 0, stream>>>(
      img, ix, iy, mask, rgb, view, warped, valid, c, h, w, p);
}

}  // namespace

// img [n, c, h, w]; ix, iy, mask, valid [n, p]; rgb, view, warped [n, c, p];
// all f32, contiguous, on the device of `stream`. Returns cudaGetLastError().
extern "C" int dmv3d_warp_composite_fwd(const float* img, const float* ix,
                                        const float* iy, const float* mask,
                                        const float* rgb, float* view,
                                        float* warped, float* valid, int n,
                                        int c, int h, int w, int p,
                                        int border, int fast, void* stream) {
  if (n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (border) {
      if (fast)
        launch<true, true>(img, ix, iy, mask, rgb, view, warped, valid, n, c,
                           h, w, p, s);
      else
        launch<true, false>(img, ix, iy, mask, rgb, view, warped, valid, n, c,
                            h, w, p, s);
    } else {
      if (fast)
        launch<false, true>(img, ix, iy, mask, rgb, view, warped, valid, n, c,
                            h, w, p, s);
      else
        launch<false, false>(img, ix, iy, mask, rgb, view, warped, valid, n,
                             c, h, w, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
