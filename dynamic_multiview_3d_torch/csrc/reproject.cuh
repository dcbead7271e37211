// The per-pixel correspondence of depth reprojection, shared by the forward
// kernels (reproject.cu) and their backward (reproject_bwd.cu), so that the
// backward samples exactly where the forward did.
//
// The TPU kernels' _correspondence (dynamic_multiview_3d_tpu/kernels/
// reproject_pallas.py) and _coords_and_ddepth: with the 12 camera scalars of
// an image, M = K R K^-1 (row-major, 9) and m = K t (3), for target pixel
// (u, v) at depth d
//   a      = M [u, v, 1]                 (d q / d depth)
//   q      = d a + m
//   valid  = q.z > 1e-6
//   (x, y) = q.xy / q.z where valid, else (-1e6, -1e6): a coordinate far
//            outside the image, which samples 0 under zeros padding
//   dx/dd  = (a.x q.z - q.x a.z) / q.z^2  (same for y), 0 where not valid
// Every product, sum and quotient is written with the _rn intrinsics (nvcc
// contracts nothing into an FMA) in the order of the plain PyTorch version,
// kernels/reproject.py correspondence_plain, which does the same operations
// one by one; the reciprocal 1 / q.z^2 is taken once, as the reference does.

#pragma once

#include <cuda_runtime.h>

namespace dmv3d {

constexpr float kReprojectEps = 1e-6f;
constexpr float kFarCoord = -1e6f;

// An image's 12 camera scalars, in registers
struct Camera {
  float m[12];

  // three 16-byte loads from prm, which must be 16-byte aligned (a row of
  // a contiguous [N, 12] array whose start is: the wrappers check it)
  static __device__ __forceinline__ Camera load(const float* prm) {
    const float4* p4 = reinterpret_cast<const float4*>(prm);
    const float4 a = __ldg(p4), b = __ldg(p4 + 1), c = __ldg(p4 + 2);
    return Camera{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z,
                   c.w}};
  }
};

struct Correspondence {
  float ax, ay, az;  // M [u, v, 1]
  float qx, qy, qz;  // d a + m
  float x, y;        // the source pixel coordinate (kFarCoord if not valid)
  bool valid;

  // cam: the image's 12 camera scalars; d: the pixel's depth; (iu, iv):
  // the pixel's column and row in the target plane
  __device__ __forceinline__ Correspondence(const Camera& cam, float d,
                                            int iu, int iv) {
    const float* prm = cam.m;
    const float u = static_cast<float>(iu);
    const float v = static_cast<float>(iv);
    ax = __fadd_rn(__fadd_rn(__fmul_rn(prm[0], u), __fmul_rn(prm[1], v)),
                   prm[2]);
    ay = __fadd_rn(__fadd_rn(__fmul_rn(prm[3], u), __fmul_rn(prm[4], v)),
                   prm[5]);
    az = __fadd_rn(__fadd_rn(__fmul_rn(prm[6], u), __fmul_rn(prm[7], v)),
                   prm[8]);
    qx = __fadd_rn(__fmul_rn(d, ax), prm[9]);
    qy = __fadd_rn(__fmul_rn(d, ay), prm[10]);
    qz = __fadd_rn(__fmul_rn(d, az), prm[11]);
    valid = qz > kReprojectEps;
    x = valid ? __fdiv_rn(qx, qz) : kFarCoord;
    y = valid ? __fdiv_rn(qy, qz) : kFarCoord;
  }

  // d depth from the coordinate's cotangents (dx, dy):
  // dx * dx/dd + dy * dy/dd
  __device__ __forceinline__ float d_depth(float dx, float dy) const {
    const float qzs = valid ? qz : 1.f;
    const float inv = __fdiv_rn(1.f, __fmul_rn(qzs, qzs));
    const float dxdd =
        valid ? __fmul_rn(__fsub_rn(__fmul_rn(ax, qz), __fmul_rn(qx, az)), inv)
              : 0.f;
    const float dydd =
        valid ? __fmul_rn(__fsub_rn(__fmul_rn(ay, qz), __fmul_rn(qy, az)), inv)
              : 0.f;
    return __fadd_rn(__fmul_rn(dx, dxdd), __fmul_rn(dy, dydd));
  }
};

}  // namespace dmv3d
