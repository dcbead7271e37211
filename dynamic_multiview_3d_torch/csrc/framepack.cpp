// Native host-side frame packer: the PyTorch port's own copy of the
// repo-root csrc/framepack.cpp, same code.
//
// The per-batch hot loop of a data source that normalizes on the host --
// bilinear resize + [-1,1] normalization + NHWC float packing -- in
// vectorizable C++ with OpenMP across frames. Built at first use by
// data/native.py (g++ -O3 -fPIC -fopenmp -shared; no external deps) and
// bound via ctypes; data/native.py keeps a numpy version of each function
// beside it.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// uint8 NHWC [n, h_in, w_in, c] -> float32 NHWC [n, h_out, w_out, c] in [-1,1]
// Bilinear resize (align_corners=false convention, matching cv2.INTER_LINEAR
// for downscale-free paths) fused with normalization.
void dmv3d_resize_normalize_pack(const uint8_t* src, int n, int h_in,
                                 int w_in, int c, float* dst, int h_out,
                                 int w_out) {
  const float sy = static_cast<float>(h_in) / h_out;
  const float sx = static_cast<float>(w_in) / w_out;
  const bool identity = (h_in == h_out && w_in == w_out);
  // Degenerate 1-pixel-tall/wide inputs: the bilinear clamp below (y0 <=
  // h_in-2) would go negative and read out of bounds; zero the fractional
  // step instead (nearest along that axis).
  const int y_step = (h_in >= 2) ? 1 : 0;
  const int x_step = (w_in >= 2) ? 1 : 0;

#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    const uint8_t* img = src + static_cast<int64_t>(i) * h_in * w_in * c;
    float* out = dst + static_cast<int64_t>(i) * h_out * w_out * c;
    if (identity) {
      const int64_t total = static_cast<int64_t>(h_out) * w_out * c;
      for (int64_t j = 0; j < total; ++j) {
        out[j] = img[j] * (1.0f / 127.5f) - 1.0f;
      }
      continue;
    }
    for (int y = 0; y < h_out; ++y) {
      float fy = (y + 0.5f) * sy - 0.5f;
      if (fy < 0) fy = 0;
      int y0 = static_cast<int>(fy);
      if (y0 > h_in - 1 - y_step) y0 = h_in - 1 - y_step;
      const float wy = y_step ? fy - y0 : 0.0f;
      for (int x = 0; x < w_out; ++x) {
        float fx = (x + 0.5f) * sx - 0.5f;
        if (fx < 0) fx = 0;
        int x0 = static_cast<int>(fx);
        if (x0 > w_in - 1 - x_step) x0 = w_in - 1 - x_step;
        const float wx = x_step ? fx - x0 : 0.0f;
        const uint8_t* p00 = img + ((int64_t)y0 * w_in + x0) * c;
        const uint8_t* p01 = p00 + x_step * c;
        const uint8_t* p10 = p00 + (int64_t)y_step * w_in * c;
        const uint8_t* p11 = p10 + x_step * c;
        float* o = out + ((int64_t)y * w_out + x) * c;
        for (int ch = 0; ch < c; ++ch) {
          const float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
          const float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
          o[ch] = (top + (bot - top) * wy) * (1.0f / 127.5f) - 1.0f;
        }
      }
    }
  }
}

// Gather examples into a batch: indices select rows of a [num, ...] uint8
// frame store; output packed/normalized float batch. Used by the frame-folder
// dataset to assemble (seq, targets) without intermediate numpy copies.
void dmv3d_gather_pack(const uint8_t* store, const int64_t* indices,
                       int n_indices, int64_t frame_elems, float* dst) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n_indices; ++i) {
    const uint8_t* img = store + indices[i] * frame_elems;
    float* out = dst + static_cast<int64_t>(i) * frame_elems;
    for (int64_t j = 0; j < frame_elems; ++j) {
      out[j] = img[j] * (1.0f / 127.5f) - 1.0f;
    }
  }
}

int dmv3d_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
