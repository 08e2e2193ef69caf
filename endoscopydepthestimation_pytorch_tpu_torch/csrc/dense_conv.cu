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
// With tensor cores the layers are therefore memory-bound, floor ~0.59 ms
// at 3.35 TB/s; on f32 FFMAs they would be FFMA-bound, floor ~2.9 ms at 67
// TFLOP/s. Both floors are derived from the shapes, not measured.
//
// Designs:
//   bf16 (serving): the implicit GEMM on the tensor cores of
//     csrc/conv3x3_mma.cuh, shared with the block engine's K4: M = 256
//     pixels of one image (8x32, 16x16 or 32x8), N = 16 (F zero-padded),
//     K = 9 taps x 16-channel chunks, mma.sync m16n8k16 with f32
//     accumulators; the activated halo is built in registers from the raw
//     x as the plain version rounds it, into two shared-memory stages. Here
//     x is read at row stride C and y written at row stride F, with no
//     statistics and an optional bias. The halo moves as 16-byte vectors
//     when C % 8 == 0, as 8-byte vectors when C % 4 == 0 (half of
//     FCDenseNet-57's layers have C = 4 mod 8), else as scalars; every
//     vector ends at or before C, so none reads the next pixel or past the
//     tensor. Where the image has few tiles (the deep levels, and batch 1)
//     the wrapper splits the 16-channel chunks across blocks, and the
//     header's finish pass sums their f32 partial y in split order.
//   f32 (the parity dtype): a direct convolution on FFMAs (no TF32). One
//     block computes a TH x TW = 16 x 32 output tile of one image with 128
//     threads; each thread owns one column and RPT = 4 rows, so every
//     weight value read from shared memory feeds 4 FMAs per output channel;
//     the channel loop runs in chunks of CC = 16: the (TH+2) x (TW+2) x CC
//     halo tile is loaded with the BN affine + ReLU applied in f32, zeros
//     outside the image and past C; the 9 x CC x FP weight slice is zero
//     padded up to FP, the feature count rounded up to a multiple of 4;
//     f32 accumulators (RPT x FP per thread); the epilogue adds the bias.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_mma.cuh"  // the bf16 body, shared with K4; CC

namespace {

constexpr int TW = 32;                       // tile width  (= threads in x)
constexpr int RPT = 4;                       // output rows per thread
constexpr int TY = 4;                        // threads in y
constexpr int TH = TY * RPT;                 // tile height
constexpr int NT = TW * TY;                  // threads per block
constexpr int HALO = (TH + 2) * (TW + 2);    // halo positions per channel
constexpr int PS = HALO + 1;                 // odd pitch: fewer bank conflicts
constexpr int MAX_FEATURES = 16;

// the f32 layer on FFMAs
template <int FP>
__global__ void __launch_bounds__(NT) dense_conv_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, int H, int W, int C,
    int F) {
  __shared__ float s_x[CC * PS];
  __shared__ __align__(16) float s_w[9 * CC * FP];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const float* xb = x + (size_t)blockIdx.z * H * W * C;

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
        v = affine_relu(xb[((size_t)gh * W + gw) * C + gc], scale[gc], shift[gc]);
      }
      s_x[c * PS + pos] = v;
    }
    // weight slice s_w[tap][c][f], zero past C and past F
    for (int e = tid; e < 9 * CC * FP; e += NT) {
      const int f = e % FP, c = (e / FP) % CC, tap = e / (FP * CC);
      const int gc = c0 + c;
      s_w[e] = (f < F && gc < C) ? w[((size_t)tap * C + gc) * F + f] : 0.f;
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
    float* yp = y + (((size_t)blockIdx.z * H + gh) * W + gw) * F;
#pragma unroll
    for (int f = 0; f < FP; ++f)
      if (f < F) yp[f] = acc[r][f] + (bias ? bias[f] : 0.f);
  }
}

cudaError_t launch_f32(const float* x, const float* scale, const float* shift,
                       const float* w, const float* bias, float* y, int B, int H,
                       int W, int C, int F, cudaStream_t stream) {
  const dim3 block(TW, TY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  switch ((F + 3) / 4) {
    case 1:
      dense_conv_fwd_kernel<4><<<grid, block, 0, stream>>>(x, scale, shift, w, bias, y, H, W, C, F);
      break;
    case 2:
      dense_conv_fwd_kernel<8><<<grid, block, 0, stream>>>(x, scale, shift, w, bias, y, H, W, C, F);
      break;
    case 3:
      dense_conv_fwd_kernel<12><<<grid, block, 0, stream>>>(x, scale, shift, w, bias, y, H, W, C, F);
      break;
    default:
      dense_conv_fwd_kernel<16><<<grid, block, 0, stream>>>(x, scale, shift, w, bias, y, H, W, C, F);
      break;
  }
  return cudaGetLastError();
}

// the bf16 halo's lanes may load vw channels at once: 16-byte (8) or
// 8-byte (4) vectors need C a multiple of vw and x aligned to the vector,
// and the weights and y move as channel pairs (F even, 4-byte aligned)
bool vector_ok(int vw, const void* x, const void* w, const void* y, int C, int F) {
  if (vw == 1) return true;
  return (vw == 8 || vw == 4) && C % vw == 0 && F % 2 == 0 &&
         reinterpret_cast<uintptr_t>(x) % (2 * vw) == 0 &&
         reinterpret_cast<uintptr_t>(w) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 4 == 0;
}

}  // namespace

extern "C" {

int dense_conv_max_features() { return MAX_FEATURES; }

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it; scale, shift and
// bias are float32). bias may be null. float32: tile_w = 32 (16x32 tiles),
// n_split = 1, vw = 1. bfloat16: tile_w = 32, 16 or 8 (tiles of 256
// pixels, 256/tile_w rows); n_split in 1 .. ceil(C/16), how many blocks
// share one tile's 16-channel chunks, with ypart (n_split, B * tiles, 256,
// 16) float32 scratch when n_split > 1; vw = 8, 4 or 1 channels a lane
// loads (vector_ok). Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for arguments the kernels do not take.
int dense_conv_fwd(int dtype, const void* x, const void* scale,
                   const void* shift, const void* w, const void* bias, void* y,
                   void* ypart, int B, int H, int W, int C, int F, int n_split,
                   int tile_w, int vw, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || F > MAX_FEATURES ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tile_w != TW || n_split != 1 || vw != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(static_cast<const float*>(x), sc, sh,
                           static_cast<const float*>(w), bi, static_cast<float*>(y),
                           B, H, W, C, F, s);
  }
  if (dtype != 1 || !mma_tile_width(tile_w) || n_split < 1 ||
      n_split > mma_tiles(C, CC) || n_split > 65535 ||
      mma_tiles(H, MMA_PIXELS / tile_w) * mma_tiles(W, tile_w) > 65535 ||
      (n_split > 1 && ypart == nullptr) || (long long)H * W * C > INT_MAX ||
      !vector_ok(vw, x, w, y, C, F))
    return (int)cudaErrorInvalidValue;
  auto* yb = static_cast<__nv_bfloat16*>(y);
  return (int)launch_conv3x3_fwd_mma<false, true>(
      static_cast<const __nv_bfloat16*>(x), C, sc, sh,
      static_cast<const __nv_bfloat16*>(w), bi, yb, F, nullptr,
      static_cast<float*>(ypart), B, H, W, C, F, n_split, tile_w, vw, s);
}

}  // extern "C"
