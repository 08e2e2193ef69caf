// Fused FC-DenseNet dense layer for Hopper (sm_90a):
//
//   y[b,h,w,f] = bias[f] + sum_{ky,kx,c} a[b,h+ky-1,w+kx-1,c] * W[ky,kx,c,f]
//   a = max(x * scale + shift, 0)      (scale/shift = the folded BatchNorm)
//
// NHWC activations, HWIO weights, SAME padding with zeros AFTER the
// activation: a tap outside the image contributes 0, not relu(shift).
//
// Replaces the Pallas TPU kernel endoscopydepthestimation_pytorch_tpu/ops/
// dense_conv.py `_fwd_kernel` (:73), launched by `_dense_conv_call` (:217).
// None of its TPU layout tricks are carried over (8-position packing of the
// matmul N dim, the (B/8, 8d, H, G, 8b, C) layout, 128-lane K chunks, VMEM
// row budgets).
//
// What bounds it on an H100. FCDenseNet-57 at batch 8, 256x320 runs 44 such
// layers (growth F = 12, Cin 48..372): 2*9*12 * sum(pixels*Cin) =
// 216 * 907,023,360 = 196 GFLOP, reading ~1.8 GB of bf16 input, i.e. ~103
// FLOP/byte, below the H100's bf16 tensor-core ridge (~295 FLOP/byte).
// With tensor cores the layers are therefore memory-bound, floor ~0.55 ms
// at 3.35 TB/s. This kernel does its MACs as FP32 FFMAs on the CUDA cores,
// so it is instead FFMA-bound, floor ~2.9 ms at 67 TFLOP/s. Both floors
// are derived from the shapes, not measured.
//
// Design (direct convolution, simple first):
//   * one block computes a TH x TW = 16 x 32 output tile of one image with
//     128 threads; each thread owns one column and RPT = 4 rows, so every
//     weight value read from shared memory feeds 4 FMAs per output channel;
//   * the channel loop runs in chunks of CC = 16: the (TH+2) x (TW+2) x CC
//     halo tile is loaded with the BN affine + ReLU applied in f32 (then
//     rounded to the element type, as the plain version rounds it), zeros
//     outside the image and past C; the 9 x CC x FP weight slice is zero
//     padded up to FP, the feature count rounded up to a multiple of 4;
//   * f32 accumulators (RPT x FP per thread); the epilogue adds the f32
//     bias and stores F contiguous values per pixel.
// float runs FFMA only (no TF32); __nv_bfloat16 reads and writes bf16 and
// accumulates in f32.
//
// Later work: move the MACs onto mma/wgmma as an implicit GEMM with
// M = pixels, N = 12 padded to 16, K = 9*C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;                       // tile width  (= threads in x)
constexpr int RPT = 4;                       // output rows per thread
constexpr int TY = 4;                        // threads in y
constexpr int TH = TY * RPT;                 // tile height
constexpr int NT = TW * TY;                  // threads per block
constexpr int CC = 16;                       // channels per chunk
constexpr int HALO = (TH + 2) * (TW + 2);    // halo positions per channel
constexpr int PS = HALO + 1;                 // odd pitch: fewer bank conflicts
constexpr int MAX_FEATURES = 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T, int FP>
__global__ void __launch_bounds__(NT) dense_conv_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
    int F) {
  __shared__ float s_x[CC * PS];
  __shared__ __align__(16) float s_w[9 * CC * FP];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const T* xb = x + (size_t)blockIdx.z * H * W * C;

  float acc[RPT][FP];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int f = 0; f < FP; ++f) acc[r][f] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    // activated halo tile, channel fastest in global memory (coalesced)
    for (int e = tid; e < HALO * CC; e += NT) {
      const int c = e % CC, pos = e / CC;
      const int gh = h0 + pos / (TW + 2) - 1, gw = w0 + pos % (TW + 2) - 1;
      const int gc = c0 + c;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C) {
        const float t = to_float(xb[((size_t)gh * W + gw) * C + gc]);
        v = to_float(from_float<T>(fmaxf(t * scale[gc] + shift[gc], 0.f)));
      }
      s_x[c * PS + pos] = v;
    }
    // weight slice s_w[tap][c][f], zero past C and past F
    for (int e = tid; e < 9 * CC * FP; e += NT) {
      const int f = e % FP, c = (e / FP) % CC, tap = e / (FP * CC);
      const int gc = c0 + c;
      s_w[e] = (f < F && gc < C) ? to_float(w[((size_t)tap * C + gc) * F + f])
                                 : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      const float* xs = s_x + c * PS + ty * RPT * (TW + 2) + tx;
      float a[RPT + 2][3];
#pragma unroll
      for (int r = 0; r < RPT + 2; ++r)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) a[r][kx] = xs[r * (TW + 2) + kx];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wv = reinterpret_cast<const float4*>(
              s_w + ((ky * 3 + kx) * CC + c) * FP);
          float wr[FP];
#pragma unroll
          for (int q = 0; q < FP / 4; ++q) {
            const float4 t = wv[q];
            wr[4 * q] = t.x;
            wr[4 * q + 1] = t.y;
            wr[4 * q + 2] = t.z;
            wr[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int f = 0; f < FP; ++f)
              acc[r][f] = fmaf(a[r + ky][kx], wr[f], acc[r][f]);
        }
    }
    __syncthreads();
  }

  const int gw = w0 + tx;
  if (gw >= W) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gh = h0 + ty * RPT + r;
    if (gh >= H) break;
    T* yp = y + (((size_t)blockIdx.z * H + gh) * W + gw) * F;
#pragma unroll
    for (int f = 0; f < FP; ++f)
      if (f < F) yp[f] = from_float<T>(acc[r][f] + (bias ? bias[f] : 0.f));
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* shift,
                   const void* w, const float* bias, void* y, int B, int H,
                   int W, int C, int F, cudaStream_t stream) {
  const dim3 block(TW, TY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  switch ((F + 3) / 4) {
    case 1:
      dense_conv_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(
          xt, scale, shift, wt, bias, yt, H, W, C, F);
      break;
    case 2:
      dense_conv_fwd_kernel<T, 8><<<grid, block, 0, stream>>>(
          xt, scale, shift, wt, bias, yt, H, W, C, F);
      break;
    case 3:
      dense_conv_fwd_kernel<T, 12><<<grid, block, 0, stream>>>(
          xt, scale, shift, wt, bias, yt, H, W, C, F);
      break;
    default:
      dense_conv_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(
          xt, scale, shift, wt, bias, yt, H, W, C, F);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_conv_max_features() { return MAX_FEATURES; }

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it; scale, shift and
// bias are float32). bias may be null. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
int dense_conv_fwd(int dtype, const void* x, const void* scale,
                   const void* shift, const void* w, const void* bias, void* y,
                   int B, int H, int W, int C, int F, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || F > MAX_FEATURES ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, sc, sh, w, bi, y, B, H, W, C, F, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, sc, sh, w, bi, y, B, H, W, C, F, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
