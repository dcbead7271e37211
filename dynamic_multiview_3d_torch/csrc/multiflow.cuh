// What the multi-source kernels (multiflow_composite.cu and its backward)
// share: the instantiation a library is built for, the launch shape and
// the blend weights, so that both compute the same weights bit for bit.
//
// Builds include this file by name after bilinear.cuh; the build cache
// (kernels/_build.py) hashes it with each source that includes it.
//
// A library holds one source count T and one padding, given to nvcc as
// -DDMV3D_MF_T=<T> -DDMV3D_MF_BORDER=<0|1> (kernels/multiflow.py, which
// builds and caches each pair at its first use): any T compiles, and a
// build compiles only the T it serves.

#pragma once

#include <stdint.h>

#include "bilinear.cuh"

#if !defined(DMV3D_MF_T) || !defined(DMV3D_MF_BORDER)
#error "build with -DDMV3D_MF_T=<sources> -DDMV3D_MF_BORDER=<0|1>"
#endif

namespace dmv3d {
namespace mf {

// Threads per block of the forward and the backward, one target pixel
// each: measured fastest on an H100 against 128 (forward) and 256
// (backward) threads and against two pixels per thread (PERF.md).
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kSources = DMV3D_MF_T;             // T of this library
constexpr bool kBorder = DMV3D_MF_BORDER != 0;   // else zeros padding
static_assert(kSources >= 1, "DMV3D_MF_T must be at least 1");
constexpr int kMaxChannels = 16;
// channels per pass over the sources' taps: the model's 3 in one pass
constexpr int kGroup = 3;

// The backward's launch bound for T sources (its one-pass
// instantiations): as many blocks per SM as its 65,536 registers hold at
// 64 + 8T registers a thread, capped at the 255 ptxas can give a thread
// (T >= 24). Unbounded, ptxas hoists every source's taps and takes 255
// registers a thread from T = 6 on, which leaves an SM 256 threads. Under
// the bound it still hoists up to it and spills a few values (4-68 bytes
// a thread from T = 4 on, to L1): measured on an H100, that beats both a
// looser and a tighter bound (PERF.md). A larger T spills more; it stays
// correct.
constexpr int bwd_registers(int t) {
  return 64 + 8 * t < 255 ? 64 + 8 * t : 255;
}
constexpr int bwd_min_blocks(int t) {
  return 65536 / (kBwdThreads * bwd_registers(t)) > 1
             ? 65536 / (kBwdThreads * bwd_registers(t))
             : 1;
}

// The T sources' coordinates x, y and blend weights wt at the target pixel
// whose first source's values sit at `row0` of ix, iy and conf ([N, T, P],
// rows P apart), and any_valid. Every coordinate and logit is read once,
// all 3T loads before any arithmetic; then, in the plain version's order:
// the logits' max (t ascending), exp(z - max), the denominator summed in t
// order, one division per weight.
template <int T>
__device__ __forceinline__ void blend(
    const float* __restrict__ ix, const float* __restrict__ iy,
    const float* __restrict__ conf, int64_t row0, int p, float wmax,
    float hmax, float (&x)[T], float (&y)[T], float (&wt)[T],
    float& any_valid) {
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const int64_t o = row0 + static_cast<int64_t>(s) * p;
    x[s] = __ldg(ix + o);
    y[s] = __ldg(iy + o);
    wt[s] = __ldg(conf + o);        // the logits, until the weights
  }
  float zmax = 0.f, anyv = 0.f;
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const float z = blend_logit(x[s], y[s], wt[s], wmax, hmax);
    wt[s] = z;
    zmax = s == 0 ? z : fmaxf(zmax, z);
    anyv = fmaxf(anyv, in_bounds(x[s], y[s], wmax, hmax));
  }
  float denom = 0.f;
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const float ez = expf(__fsub_rn(wt[s], zmax));
    wt[s] = ez;
    denom = s == 0 ? ez : __fadd_rn(denom, ez);
  }
#pragma unroll
  for (int s = 0; s < T; ++s) wt[s] = __fdiv_rn(wt[s], denom);
  any_valid = anyv;
}

// blocks of `threads` threads, each thread one pixel of one example
// (grid.y)
inline dim3 grid(int n, int p, int threads) {
  return dim3((p + threads - 1) / threads, n);
}

}  // namespace mf
}  // namespace dmv3d
