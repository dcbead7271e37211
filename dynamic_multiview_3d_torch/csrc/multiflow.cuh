// What the multi-source kernels (multiflow_composite.cu and its backward)
// share: the launch shape, the blend weights and the table of
// instantiations over T, so that both compute the same weights bit for bit.
//
// Builds include this file by name after bilinear.cuh; the build cache
// (kernels/_build.py) hashes it with each source that includes it.

#pragma once

#include <stdint.h>

#include <utility>

#include "bilinear.cuh"

namespace dmv3d {
namespace mf {

// Threads per block of the forward and the backward, one target pixel
// each: measured fastest on an H100 against 128 (forward) and 256
// (backward) threads and against two pixels per thread (PERF.md).
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kMaxSources = 16;   // T is a template parameter, 1..16
constexpr int kMaxChannels = 16;
// channels per pass over the sources' taps: the model's 3 in one pass
constexpr int kGroup = 3;

// The backward's launch bound for T sources (its one-pass
// instantiations): as many blocks per SM as its 65,536 registers hold at
// 64 + 8T registers a thread. Unbounded, ptxas hoists every source's taps
// and takes 255 registers a thread from T = 6 on, which leaves an SM 256
// threads. Under the bound it still hoists up to it and spills a few
// values (4-68 bytes a thread from T = 4 on, to L1): measured on an H100,
// that beats both a looser and a tighter bound (PERF.md).
constexpr int bwd_min_blocks(int t) {
  return 65536 / (kBwdThreads * (64 + 8 * t)) > 1
             ? 65536 / (kBwdThreads * (64 + 8 * t))
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

// A kernel's instantiation for a runtime T (1..kMaxSources) and
// precision: K::get<T, kFast>() names it.
template <class K, int... I>
auto pick(int t, bool fast, std::integer_sequence<int, I...>) {
  using Fn = decltype(K::template get<1, false>());
  const Fn table[][2] = {{K::template get<I + 1, false>(),
                          K::template get<I + 1, true>()}...};
  return table[t - 1][fast];
}

template <class K>
auto pick(int t, bool fast) {
  return pick<K>(t, fast, std::make_integer_sequence<int, kMaxSources>());
}

// blocks of `threads` threads, each thread one pixel of one example
// (grid.y)
inline dim3 grid(int n, int p, int threads) {
  return dim3((p + threads - 1) / threads, n);
}

}  // namespace mf
}  // namespace dmv3d
