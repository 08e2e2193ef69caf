// Native sparse-supervision rasterizer.
//
// The port's copy of the JAX package's native/rasterizer.cpp, the C++
// twin of data/rasterizer.py (semantics of reference utils.py:460-612):
// projects SfM points into both frames of a training pair and scatters
// per-pixel sparse depth / flow labels. This runs per sample per iteration on the host, so it is the
// data pipeline's hot spot at scale; the C++ path removes the Python/numpy
// dispatch overhead (~10x for large point clouds) and frees loader threads
// from the GIL.
//
// Bit-level parity notes:
//  * pixel coordinates use rint() (round-half-to-even, matching np.round);
//  * scatter is last-write-wins in point order (numpy fancy assignment);
//  * flow components with |f| > 5 are zeroed and unmasked post-scatter.
//
// Built by data/native.py: g++ -O3 -fPIC -shared, into build/native/.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// points: (n, 4) float64 homogeneous, row-major.
// proj_*: (3, 4) float64; ext_*: (4, 4) float64.
// vis_*: (n,) float32 smoothed visibility for the two views.
// clean: (n,) float32 or nullptr.
// mask: (h, w) uint8 (255 = inside boundary).
// Outputs (caller-zeroed): depth_mask, depth: (2, h, w) float32;
// flow_mask: (2, h, w) float32; flow: (2, h, w, 2) float32.
void rasterize_pair(const double* points, int64_t n,
                    const double* proj_1, const double* ext_1,
                    const double* proj_2, const double* ext_2,
                    const float* vis_1, const float* vis_2,
                    const float* clean, int has_clean,
                    const uint8_t* mask, int64_t h, int64_t w,
                    float* depth_mask, float* depth,
                    float* flow_mask, float* flow) {
  const int64_t hw = h * w;

  // Precompute rounded 2-D projections and camera-frame z for all points
  // in both frames (reference rounds the full homogeneous-normalized
  // vector before any bounds check, utils.py:483).
  double* u = new double[2 * n];
  double* v = new double[2 * n];
  double* z = new double[2 * n];
  const double* projs[2] = {proj_1, proj_2};
  const double* exts[2] = {ext_1, ext_2};
  for (int f = 0; f < 2; ++f) {
    const double* P = projs[f];
    const double* E = exts[f];
    for (int64_t i = 0; i < n; ++i) {
      const double* p = points + 4 * i;
      double pu = P[0] * p[0] + P[1] * p[1] + P[2] * p[2] + P[3] * p[3];
      double pv = P[4] * p[0] + P[5] * p[1] + P[6] * p[2] + P[7] * p[3];
      double pw = P[8] * p[0] + P[9] * p[1] + P[10] * p[2] + P[11] * p[3];
      u[f * n + i] = std::rint(pu / pw);
      v[f * n + i] = std::rint(pv / pw);
      double cz = E[8] * p[0] + E[9] * p[1] + E[10] * p[2] + E[11] * p[3];
      double cw = E[12] * p[0] + E[13] * p[1] + E[14] * p[2] + E[15] * p[3];
      z[f * n + i] = cz / cw;
    }
  }

  for (int f = 0; f < 2; ++f) {
    const float* vis = (f == 0) ? vis_1 : vis_2;
    const int other = 1 - f;
    float* dm = depth_mask + f * hw;
    float* dp = depth + f * hw;
    float* fm = flow_mask + f * hw;
    float* fl = flow + f * hw * 2;

    for (int64_t i = 0; i < n; ++i) {
      if (vis[i] <= 0.5f) continue;
      if (has_clean && clean[i] <= 0.5f) continue;
      double uu = u[f * n + i];
      double vv = v[f * n + i];
      double zz = z[f * n + i];
      if (!(uu >= 0.0 && uu <= (double)(w - 1) &&
            vv >= 0.0 && vv <= (double)(h - 1) && zz > 0.0)) continue;
      int64_t loc = (int64_t)std::rint(uu) + (int64_t)std::rint(vv) * w;
      if (mask[loc] != 255) continue;

      fm[loc] = 1.0f;
      // cast the (integral) pixel delta to f32 before the f32 divide —
      // matches numpy's float32 in-place division for bitwise parity
      fl[2 * loc] = (float)(u[other * n + i] - uu) / (float)w;
      fl[2 * loc + 1] = (float)(v[other * n + i] - vv) / (float)h;
      dp[loc] = (float)zz;
      dm[loc] = 1.0f;
    }

    // flow-outlier rejection over the scattered image
    // (reference utils.py:567-574)
    for (int64_t loc = 0; loc < hw; ++loc) {
      if (std::fabs(fl[2 * loc]) > 5.0f || std::fabs(fl[2 * loc + 1]) > 5.0f) {
        fm[loc] = 0.0f;
        fl[2 * loc] = 0.0f;
        fl[2 * loc + 1] = 0.0f;
      }
    }
  }

  delete[] u;
  delete[] v;
  delete[] z;
}

}  // extern "C"
