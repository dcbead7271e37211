// The device draw of one train step: each example's scene, source views,
// target views and first frame, drawn as jax.random draws them.
//
// Replaces no pallas_call. The JAX package's step draws its examples with
// jax.random inside its compiled program (dynamic_multiview_3d_tpu/data/
// resident.py ResidentFrames.device_sample, keyed by train/step.py
// _one_step); XLA compiles those draws to threefry2x32. This kernel is the
// whole of that draw in one launch a step. Its plain version is
// jax_draw_plain in kernels/jax_draw.py, torch ops over
// utils/jax_random.py; both are bitwise jax.random's.
//
// Per example i (one thread), with the step's sampling key ks:
//   kk = fold_in(ks, index_offset + i);  k1..k4 = split(kk, 4)
//   scene = randint(k1, (), 0, S)
//   sources: orbit, V >= T: permutation(k2, V)[:T]
//            orbit, V < T:  randint(k2, (T,), 0, V)
//            fixed:         randint(k2, (), 0, V), repeated T times
//   targets: V >= K: permutation(k3, V)[:K];  V < K: randint(k3, (K,), 0, V)
//   t0 = randint(k4, (), 0, t_avail - T + 1)
// and the rows: seq (scene*V + src)*t_avail + t0 + t, tgt (scene*V +
// tgt)*t_avail + t0 + T - 1, and the pose rows scene*V + view.
// threefry2x32, fold_in, split, 32-bit bits, randint and permutation are
// jax/_src/prng.py's and random.py's with jax_threefry_partitionable on:
// counters (i >> 32, i & 0xffffffff) (i < 2^32 here, so hi = 0), uint32
// arithmetic that wraps (randint's multiplier and sum), and permutation's
// rounds of fresh 32-bit keys and a stable sort (an insertion sort that
// moves an element only past strictly larger keys).
//
// Bound on an H100 SXM: neither bytes nor operations. The c3md step draws
// B = 8 examples (T = 8 of V = 8 views, K = 2): about 35 threefry calls of
// ~120 integer operations an example, ~34,000 in all, and 1,280 B of rows
// written; both are far below a microsecond. What a step pays is the
// launch. The design is for that: one launch a step, one thread an
// example (the draws of an example are sequential: each key comes from
// the last), every scalar (the key, the offset, the sizes) passed by
// value, so a step copies nothing to the device; the permutations sort in
// a workspace [V, B] in device memory (a thread's column: neighbouring
// threads touch neighbouring words), so any V runs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counters (x0, x1) under k
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

// split(k, n)[i] and fold_in(k, i): the same counters (0, i)
__device__ __forceinline__ Key child(Key k, uint32_t i) {
  return threefry(k, 0u, i);
}

// bits(k, shape, uint32) at flat index i
__device__ __forceinline__ uint32_t bits(Key k, uint32_t i) {
  const Key y = threefry(k, 0u, i);
  return y.a ^ y.b;
}

// randint(k, shape, 0, span)[i], span >= 1
__device__ __forceinline__ uint32_t randint(Key k, uint32_t i,
                                            uint32_t span) {
  const uint32_t hi = bits(child(k, 0u), i);
  const uint32_t lo = bits(child(k, 1u), i);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  return (hi % span * mult + lo % span) % span;
}

// permutation(k, v) into vals[0..v) (stride b: this thread's column of
// the [V, B] workspace), with keys[] as the sort keys' workspace
__device__ void permutation(Key k, int v, int rounds, int b, uint32_t* keys,
                            int32_t* vals) {
  for (int j = 0; j < v; ++j) vals[j * b] = j;
  for (int r = 0; r < rounds; ++r) {
    const Key sub = child(k, 1u);
    k = child(k, 0u);
    for (int j = 0; j < v; ++j) keys[j * b] = bits(sub, j);
    for (int j = 1; j < v; ++j) {         // stable: only past larger keys
      const uint32_t key = keys[j * b];
      const int32_t val = vals[j * b];
      int i = j - 1;
      for (; i >= 0 && keys[i * b] > key; --i) {
        keys[(i + 1) * b] = keys[i * b];
        vals[(i + 1) * b] = vals[i * b];
      }
      keys[(i + 1) * b] = key;
      vals[(i + 1) * b] = val;
    }
  }
}

__global__ void __launch_bounds__(kThreads) jax_draw_kernel(
    int64_t* __restrict__ seq, int64_t* __restrict__ tgt,
    int64_t* __restrict__ src_pose, int64_t* __restrict__ tgt_pose,
    uint32_t* __restrict__ ws_keys, int32_t* __restrict__ ws_vals, Key ks,
    uint32_t offset, int b, int s, int v, int t_avail, int t_len, int k,
    int orbit, int rounds) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= b) return;
  const Key kk = child(ks, offset + static_cast<uint32_t>(n));
  const Key k1 = child(kk, 0u), k2 = child(kk, 1u), k3 = child(kk, 2u),
            k4 = child(kk, 3u);
  uint32_t* keys = ws_keys + n;
  int32_t* vals = ws_vals + n;
  const int64_t scene = randint(k1, 0u, static_cast<uint32_t>(s));
  const int64_t t0 =
      randint(k4, 0u, static_cast<uint32_t>(t_avail - t_len + 1));
  const int64_t base = scene * v;
  if (orbit && v >= t_len) permutation(k2, v, rounds, b, keys, vals);
  const int64_t fixed =
      orbit ? 0 : randint(k2, 0u, static_cast<uint32_t>(v));
  for (int t = 0; t < t_len; ++t) {
    const int64_t view =
        !orbit ? fixed
               : (v >= t_len ? vals[t * b]
                             : randint(k2, t, static_cast<uint32_t>(v)));
    src_pose[n * t_len + t] = base + view;
    seq[n * t_len + t] = (base + view) * t_avail + t0 + t;
  }
  if (v >= k) permutation(k3, v, rounds, b, keys, vals);
  for (int j = 0; j < k; ++j) {
    const int64_t view =
        v >= k ? vals[j * b] : randint(k3, j, static_cast<uint32_t>(v));
    tgt_pose[n * k + j] = base + view;
    tgt[n * k + j] = (base + view) * t_avail + t0 + t_len - 1;
  }
}

}  // namespace

// seq [B, T], tgt [B, K], src_pose [B, T], tgt_pose [B, K] int64; the
// workspace ws_keys, ws_vals [V, B] (32-bit); key0, key1 the step's
// sampling key (uint32 bits passed as int)
extern "C" int dmv3d_jax_draw(int64_t* seq, int64_t* tgt, int64_t* src_pose,
                              int64_t* tgt_pose, uint32_t* ws_keys,
                              int32_t* ws_vals, int key0, int key1,
                              int offset, int b, int s, int v, int t_avail,
                              int t_len, int k, int orbit, int rounds,
                              void* stream) {
  if (b > 0) {
    const Key ks = {static_cast<uint32_t>(key0), static_cast<uint32_t>(key1)};
    jax_draw_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        seq, tgt, src_pose, tgt_pose, ws_keys, ws_vals, ks,
        static_cast<uint32_t>(offset), b, s, v, t_avail, t_len, k, orbit,
        rounds);
  }
  return static_cast<int>(cudaGetLastError());
}
