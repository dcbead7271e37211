// Bilinear taps shared by the port's gather kernels (warp_composite*.cu,
// sample.cu, multiflow_composite*.cu, reproject*.cu), forward and
// backward, so that every kernel computes the same weights, samples and
// subgradients bit for bit.
//
// The TPU kernels' tent weights relu(1 - |h - c|) are exactly the floor and
// floor+1 taps used here. A sample combines the y-taps first, then the
// x-taps, in the TPU kernels' order. precision "fast" (kFast) rounds what
// the TPU's single-pass bf16 matmuls round: the image values and the
// y-weights of a sample; x-weights and sums stay f32. Every product and sum
// is written with the _rn intrinsics so nvcc contracts nothing into an FMA:
// the order is that of the plain PyTorch versions in kernels/grid_sample.py
// and kernels/multiflow.py, which do the same operations one by one.
//
// Builds include this file by name (#include "bilinear.cuh"); the build
// cache (kernels/_build.py) hashes it with each source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmv3d {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a*b + c*d, each product rounded, then the sum
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// 1 where the unclamped coordinate (x, y) lies in the image, else 0
__device__ __forceinline__ float in_bounds(float x, float y, float wmax,
                                           float hmax) {
  return (x >= 0.f && x <= wmax && y >= 0.f && y <= hmax) ? 1.f : 0.f;
}

// The four taps of one pixel coordinate pair (x, y) in an h x w plane, under
// border padding (kBorder: clamp the coordinate into the image) or zeros
// padding (a tap outside the image weighs 0), with everything a forward or
// backward needs. Inlined, what a kernel does not read is never computed.
template <bool kBorder, bool kFast>
struct Taps {
  int o00, o10, o01, o11;  // plane offsets of (y0,x0) (y1,x0) (y0,x1) (y1,x1)
  float wx0, wx1, wy0, wy1;  // the tap weights, f32
  float wys0, wys1;          // the y-weights of a sample: bf16 under kFast
  // the TPU kernels' floor-tap subgradient (_tent_grad_t) of the weights:
  // -1 for the floor tap and +1 for the next, each where that tap lies in
  // the image; under border padding both 0 where the unclamped coordinate
  // is outside [0, size-1] (inclusive), so a coordinate exactly on the far
  // edge gets -v(edge)
  float ux0, ux1, uy0, uy1;

  __device__ __forceinline__ Taps(float x, float y, int h, int w) {
    const float wmax = static_cast<float>(w - 1);
    const float hmax = static_cast<float>(h - 1);
    const bool in_x = x >= 0.f && x <= wmax;
    const bool in_y = y >= 0.f && y <= hmax;
    if (kBorder) {
      x = fminf(fmaxf(x, 0.f), wmax);
      y = fminf(fmaxf(y, 0.f), hmax);
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    wx1 = __fsub_rn(x, x0f);
    wy1 = __fsub_rn(y, y0f);
    wx0 = __fsub_rn(1.f, wx1);
    wy0 = __fsub_rn(1.f, wy1);
    const bool x0_in = x0f >= 0.f && x0f <= wmax;
    const bool x1_in = x0f + 1.f >= 0.f && x0f + 1.f <= wmax;
    const bool y0_in = y0f >= 0.f && y0f <= hmax;
    const bool y1_in = y0f + 1.f >= 0.f && y0f + 1.f <= hmax;
    if (!kBorder) {  // zeros padding: out-of-range taps have no weight
      if (!x0_in) wx0 = 0.f;
      if (!x1_in) wx1 = 0.f;
      if (!y0_in) wy0 = 0.f;
      if (!y1_in) wy1 = 0.f;
    }
    wys0 = kFast ? round_bf16(wy0) : wy0;
    wys1 = kFast ? round_bf16(wy1) : wy1;
    ux0 = x0_in ? -1.f : 0.f;
    ux1 = x1_in ? 1.f : 0.f;
    uy0 = y0_in ? -1.f : 0.f;
    uy1 = y1_in ? 1.f : 0.f;
    if (kBorder && !in_x) ux0 = ux1 = 0.f;
    if (kBorder && !in_y) uy0 = uy1 = 0.f;
    // clamped tap indices (a tap outside the image has weight 0 or, under
    // border padding, sits at the edge already)
    const int xa = static_cast<int>(fminf(fmaxf(x0f, 0.f), wmax));
    const int xb = static_cast<int>(fminf(fmaxf(x0f + 1.f, 0.f), wmax));
    const int ya = static_cast<int>(fminf(fmaxf(y0f, 0.f), hmax));
    const int yb = static_cast<int>(fminf(fmaxf(y0f + 1.f, 0.f), hmax));
    o00 = ya * w + xa;
    o10 = yb * w + xa;
    o01 = ya * w + xb;
    o11 = yb * w + xb;
  }

  // Zeros padding only: whether tap i (0-3: v00 v10 v01 v11, the order of
  // load) has weight. A tap outside the image has none, so no tap of a far
  // coordinate (a pixel that is not valid) has any; nor has the next tap of
  // an integer coordinate. A gather may skip the load of a tap without
  // weight and take 0 for it: its products are then +0 where they were
  // +-0, so the sample is value-equal to the one with the load (|a - b| =
  // 0), unless the skipped value is not finite (0 * inf or NaN is NaN).
  __device__ __forceinline__ bool weighted(int i) const {
    static_assert(!kBorder, "border padding loads every tap");
    return ((i & 1) ? wy1 : wy0) != 0.f && ((i & 2) ? wx1 : wx0) != 0.f;
  }

  // the four tap values of one channel whose pixels lie `stride` floats
  // apart (1: a plane; C: channels-last, `ch` at the channel's first
  // value), v00 v10 v01 v11 (bf16 under kFast)
  __device__ __forceinline__ void load(const float* ch, int stride,
                                       float* v) const {
    v[0] = __ldg(ch + static_cast<int64_t>(o00) * stride);
    v[1] = __ldg(ch + static_cast<int64_t>(o10) * stride);
    v[2] = __ldg(ch + static_cast<int64_t>(o01) * stride);
    v[3] = __ldg(ch + static_cast<int64_t>(o11) * stride);
    if (kFast) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = round_bf16(v[i]);
    }
  }
  // the four tap values of one plane
  __device__ __forceinline__ void load(const float* plane, float* v) const {
    load(plane, 1, v);
  }
  // load under zeros padding, issuing only the loads of the taps with
  // weight (weighted); the others are 0
  __device__ __forceinline__ void load_weighted(const float* ch, int stride,
                                                float* v) const {
    const int o[4] = {o00, o10, o01, o11};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = weighted(i) ? __ldg(ch + static_cast<int64_t>(o[i]) * stride)
                         : 0.f;
    if (kFast) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = round_bf16(v[i]);
    }
  }
  // the four tap values of each of C channels of one channels-last frame
  // (`frame` at its first value), v[ch] as in load: C = 3 reads a frame
  // staged as [H, W, 4] (16-byte aligned, the fourth lane unused), one
  // 16-byte load per tap. All 4C loads are issued before any is used.
  // kWeighted (zeros padding): only the taps with weight are loaded, as in
  // load_weighted.
  template <int C, bool kWeighted = false>
  __device__ __forceinline__ void load_channels(const float* frame,
                                                float (&v)[C][4]) const {
    if constexpr (C == 3) {
      const float4* f = reinterpret_cast<const float4*>(frame);
      float4 t[4];
      if constexpr (kWeighted) {
        const int o[4] = {o00, o10, o01, o11};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          t[i] = weighted(i) ? __ldg(f + o[i])
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        t[0] = __ldg(f + o00);
        t[1] = __ldg(f + o10);
        t[2] = __ldg(f + o01);
        t[3] = __ldg(f + o11);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[0][i] = kFast ? round_bf16(t[i].x) : t[i].x;
        v[1][i] = kFast ? round_bf16(t[i].y) : t[i].y;
        v[2][i] = kFast ? round_bf16(t[i].z) : t[i].z;
      }
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        if constexpr (kWeighted)
          load_weighted(frame + ch, C, v[ch]);
        else
          load(frame + ch, C, v[ch]);
      }
    }
  }

  // the y-lerped columns x0 and x0+1 of the sample
  __device__ __forceinline__ float col0(const float* v) const {
    return dot2(wys0, v[0], wys1, v[1]);
  }
  __device__ __forceinline__ float col1(const float* v) const {
    return dot2(wys0, v[2], wys1, v[3]);
  }
  // the sample from its columns
  __device__ __forceinline__ float lerp(float t0, float t1) const {
    return dot2(wx0, t0, wx1, t1);
  }
  // d sample / dx and d sample / dy under the floor-tap subgradient (wx
  // stays f32 in the second, as in the TPU's fast backward)
  __device__ __forceinline__ float grad_x(float t0, float t1) const {
    return dot2(ux0, t0, ux1, t1);
  }
  __device__ __forceinline__ float grad_y(const float* v) const {
    return dot2(wx0, dot2(uy0, v[0], uy1, v[1]), wx1,
                dot2(uy0, v[2], uy1, v[3]));
  }

  // d_ch += (wy * ds) * wx at the four taps of one channel whose pixels
  // lie `stride` floats apart (as in load), with atomics: under kFast both
  // factors are rounded to bf16, as in the TPU's fast backward. A tap of
  // weight 0 adds nothing: its atomic is skipped.
  __device__ __forceinline__ void scatter(float* d_ch, int stride,
                                          float ds) const {
    float a0 = __fmul_rn(wy0, ds);
    float a1 = __fmul_rn(wy1, ds);
    const float b0 = kFast ? round_bf16(wx0) : wx0;
    const float b1 = kFast ? round_bf16(wx1) : wx1;
    if (kFast) {
      a0 = round_bf16(a0);
      a1 = round_bf16(a1);
    }
    if (a0 != 0.f && b0 != 0.f)
      atomicAdd(d_ch + static_cast<int64_t>(o00) * stride, __fmul_rn(a0, b0));
    if (a1 != 0.f && b0 != 0.f)
      atomicAdd(d_ch + static_cast<int64_t>(o10) * stride, __fmul_rn(a1, b0));
    if (a0 != 0.f && b1 != 0.f)
      atomicAdd(d_ch + static_cast<int64_t>(o01) * stride, __fmul_rn(a0, b1));
    if (a1 != 0.f && b1 != 0.f)
      atomicAdd(d_ch + static_cast<int64_t>(o11) * stride, __fmul_rn(a1, b1));
  }
  // the same on one plane
  __device__ __forceinline__ void scatter(float* d_plane, float ds) const {
    scatter(d_plane, 1, ds);
  }
};

// The multi-source blend logit of one source: its confidence, pushed down
// by 30 where the source's coordinate falls outside the image
// (multiflow_pallas._blend_weights)
__device__ __forceinline__ float blend_logit(float x, float y, float conf,
                                             float wmax, float hmax) {
  return __fadd_rn(
      conf, __fmul_rn(__fsub_rn(in_bounds(x, y, wmax, hmax), 1.f), 30.f));
}

}  // namespace dmv3d
