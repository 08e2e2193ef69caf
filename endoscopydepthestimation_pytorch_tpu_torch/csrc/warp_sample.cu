// Bilinear warp sampler for Hopper (sm_90a): forward (K2) and backward (K3).
//
//   out[b,q,c] = sum over the 4 taps (yi, xi) of img[b,yi,xi,c] * weight
//   (x0, y0) = floor(px, py), (wx, wy) = (px - x0, py - y0), taps
//   (y0|y0+1, x0|x0+1) with bilinear weights; a tap outside [0, W-1] x
//   [0, H-1] contributes 0 (grid_sample's zeros padding).
//
// f32 NHWC image (B, H, W, C) as it lies; per-query pixel coordinates
// px, py (B, Hq, Wq), already shifted by the caller to the
// align_corners=False convention and clamped to [-2, size+1], so floor()
// fits an int.
//
// Replaces the Pallas TPU kernels endoscopydepthestimation_pytorch_tpu/ops/
// warp_pallas.py `_fwd_kernel` (:98, launched by `_sample_fwd_impl` :171)
// and `_bwd_kernel` (:110, launched by `_bwd_impl` :217). The TPU design
// (one-hot tent matrices contracted on the MXU, 8-row VMEM blocks, the CHW
// transpose) is not carried over: on this card the sample is a gather.
//
// What bounds it on an H100: memory. At the train step's shape (image
// 16x256x320x2 f32) the forward moves ~31 MB (image 10.5 MB, px+py
// 10.5 MB, out 10.5 MB) and the backward ~37 MB plus 4 f32 atomics per
// query: a floor of ~10 us each at 3.35 TB/s (derived from the shapes, not
// measured). Neighbouring threads take neighbouring queries, whose taps lie
// on neighbouring texels for a smooth warp, so the gathers coalesce well
// and the image stays in L2 (50 MB).
//
// Design (simple first): one thread per query (b, q). C is 1 or 2; a
// texel's two channels are one 8-byte load. The backward scatters d(img)
// with f32 atomicAdd into a buffer the caller zeroed, so d(img) is exact
// per contribution but its last bit depends on the order the atomics land
// in.
// At an integer coordinate the derivative is the floor-based one-sided one
// (taps x0 and x0+1), as in the Pallas kernel and the gather's autodiff.
//
// NaN: a NaN coordinate gives NaN weights, and every tap's value (0 for an
// invalid tap) is multiplied by them, so the sample is NaN, as the Pallas
// tent max(0, NaN) gives. Its integer tap index comes from
// __float2int_rz(NaN), which PTX defines as 0, so no read goes astray.
// Nothing tests for NaN and skips taps.
//
// Later work: a deterministic backward (per-block partial sums of dimg),
// and fusing the coordinate math of geometry.warp_depth into the forward.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int MAX_CHANNELS = 2;  // the train step's [depth, mask]

template <int C>
__device__ __forceinline__ void load_texel(const float* __restrict__ p,
                                           float (&v)[C]) {
  if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// The four taps of one query: integer corners, validity, fractions.
struct Taps {
  int x0, y0;
  bool vx0, vx1, vy0, vy1;
  float wx, wy;
};

__device__ __forceinline__ Taps taps_of(float x, float y, int H, int W) {
  Taps t;
  const float x0f = floorf(x), y0f = floorf(y);
  t.wx = x - x0f;
  t.wy = y - y0f;
  t.x0 = __float2int_rz(x0f);  // NaN -> 0 (PTX), in range after the clamp
  t.y0 = __float2int_rz(y0f);
  t.vx0 = t.x0 >= 0 && t.x0 <= W - 1;
  t.vx1 = t.x0 + 1 >= 0 && t.x0 + 1 <= W - 1;
  t.vy0 = t.y0 >= 0 && t.y0 <= H - 1;
  t.vy1 = t.y0 + 1 >= 0 && t.y0 + 1 <= H - 1;
  return t;
}

// v[k][c] for the taps k = 00, 01, 10, 11 (row, column); 0 when invalid.
template <int C>
__device__ __forceinline__ void gather(const float* __restrict__ img,
                                       const Taps& t, int W, int CS,
                                       float (&v)[4][C]) {
  const bool valid[4] = {t.vy0 && t.vx0, t.vy0 && t.vx1, t.vy1 && t.vx0,
                         t.vy1 && t.vx1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (valid[k]) {
      const int yi = t.y0 + (k >> 1), xi = t.x0 + (k & 1);
      load_texel<C>(img + ((size_t)yi * W + xi) * CS, v[k]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[k][c] = 0.f;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(NT) warp_sample_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ px,
    const float* __restrict__ py, float* __restrict__ out, int B, int H,
    int W, long long Q) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)B * Q) return;
  const int b = (int)(i / Q);
  const Taps t = taps_of(px[i], py[i], H, W);
  float v[4][C];
  gather<C>(img + (size_t)b * H * W * C, t, W, C, v);
  float r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // the gather formulation's order: rows first, then between rows
    const float top = v[0][c] * (1.f - t.wx) + v[1][c] * t.wx;
    const float bot = v[2][c] * (1.f - t.wx) + v[3][c] * t.wx;
    r[c] = top * (1.f - t.wy) + bot * t.wy;
  }
  float* o = out + (size_t)i * C;
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = r[c];
  }
}

// CG: channels that carry a gradient (the first CG of the CS stored in
// img, g and dimg); the others are neither read nor written.
template <int CG>
__global__ void __launch_bounds__(NT) warp_sample_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ g,
    float* __restrict__ dimg, float* __restrict__ dpx,
    float* __restrict__ dpy, int B, int H, int W, int CS, long long Q) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)B * Q) return;
  const int b = (int)(i / Q);
  const Taps t = taps_of(px[i], py[i], H, W);
  const size_t base = (size_t)b * H * W * CS;
  float v[4][CG];
  gather<CG>(img + base, t, W, CS, v);
  const bool valid[4] = {t.vy0 && t.vx0, t.vy0 && t.vx1, t.vy1 && t.vx0,
                         t.vy1 && t.vx1};
  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    const float gc = g[(size_t)i * CS + c];
    gx += gc * ((1.f - t.wy) * (v[1][c] - v[0][c]) +
                t.wy * (v[3][c] - v[2][c]));
    gy += gc * ((1.f - t.wx) * (v[2][c] - v[0][c]) +
                t.wx * (v[3][c] - v[1][c]));
    // the adjoint of the forward's order: g through the row mix first
    const float gt = gc * (1.f - t.wy), gb = gc * t.wy;
    const float d[4] = {gt * (1.f - t.wx), gt * t.wx, gb * (1.f - t.wx),
                        gb * t.wx};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (valid[k]) {
        const int yi = t.y0 + (k >> 1), xi = t.x0 + (k & 1);
        atomicAdd(dimg + base + ((size_t)yi * W + xi) * CS + c, d[k]);
      }
    }
  }
  dpx[i] = gx;
  dpy[i] = gy;
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + NT - 1) / NT); }

}  // namespace

extern "C" {

int warp_sample_max_channels() { return MAX_CHANNELS; }

// img (B, H, W, C), px/py (B, Hq, Wq), out (B, Hq, Wq, C); all f32,
// contiguous. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int warp_sample_fwd(const void* img, const void* px, const void* py,
                    void* out, int B, int H, int W, int C, int Hq, int Wq,
                    void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hq < 1 || Wq < 1 || C < 1 ||
      C > MAX_CHANNELS)
    return (int)cudaErrorInvalidValue;
  const long long Q = (long long)Hq * Wq;
  const unsigned grid = blocks_for((long long)B * Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  float* o = static_cast<float*>(out);
  if (C == 1)
    warp_sample_fwd_kernel<1><<<grid, NT, 0, s>>>(im, x, y, o, B, H, W, Q);
  else
    warp_sample_fwd_kernel<2><<<grid, NT, 0, s>>>(im, x, y, o, B, H, W, Q);
  return (int)cudaGetLastError();
}

// img and g (B, H, W, C) / (B, Hq, Wq, C), dimg (B, H, W, C) zeroed by the
// caller, dpx/dpy (B, Hq, Wq); all f32, contiguous. Only the first CG
// channels are read and scattered (CG = 1: the grad-first variant).
int warp_sample_bwd(const void* img, const void* px, const void* py,
                    const void* g, void* dimg, void* dpx, void* dpy, int B,
                    int H, int W, int C, int CG, int Hq, int Wq,
                    void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hq < 1 || Wq < 1 || C < 1 ||
      C > MAX_CHANNELS || CG < 1 || CG > C)
    return (int)cudaErrorInvalidValue;
  const long long Q = (long long)Hq * Wq;
  const unsigned grid = blocks_for((long long)B * Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* gg = static_cast<const float*>(g);
  float* di = static_cast<float*>(dimg);
  float* dx = static_cast<float*>(dpx);
  float* dy = static_cast<float*>(dpy);
  if (CG == 1)
    warp_sample_bwd_kernel<1><<<grid, NT, 0, s>>>(im, x, y, gg, di, dx, dy, B, H, W, C, Q);
  else
    warp_sample_bwd_kernel<2><<<grid, NT, 0, s>>>(im, x, y, gg, di, dx, dy, B, H, W, C, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
