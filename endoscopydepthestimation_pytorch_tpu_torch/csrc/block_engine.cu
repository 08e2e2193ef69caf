// The whole-dense-block engine's three per-layer kernels for Hopper (sm_90a).
//
// A dense block of L layers with growth F keeps ONE NHWC buffer
// buf (B, H, W, ld), ld = C0 + L*F: the block input in channels [0, C0) and
// layer j's output in [C0 + j*F, C0 + (j+1)*F). Layer j reads the channel
// prefix [0, C) with C = C0 + j*F at row stride ld, so no concatenation
// ever exists. The backward works on one gradient buffer of the same shape.
// With a = max(x*scale + shift, 0) (the folded BatchNorm, in f32, rounded to
// the element type, zero outside the image) and gy_eff = g + c1 + c2*y (the
// block's lazily applied BN-through-statistics gradient, rounded likewise):
//
//   K4 block_engine_fwd      y = conv3x3(a, W) + bias into buf[..., C:C+F],
//                            with per-block partial (sum y, sum y^2) of the
//                            stored (rounded) y
//   K5 block_engine_dinput   da = conv3x3^T(gy_eff, W); dpre = da * (a > 0);
//                            grad[..., :C] += dpre*scale in place; per-block
//                            partial (sum dpre*x, sum dpre) per channel and
//                            sum gy_eff per output channel
//   K6 block_engine_dweight  dW[ky,kx,c,f] = sum_p a[p+(ky-1,kx-1),c] *
//                            gy_eff[p,f], as per-block f32 partials over
//                            strided tile sets, summed in a second pass
//
// and, once a block, its boundary with the rest of the network (the input
// x is the C0-channel prefix of buf):
//
//   block_engine_entry       x (B, H, W, C0) into buf[..., :C0], and x's
//                            per-channel (mean, mean of squares): per-block
//                            f64 partials, summed in block order by a
//                            second pass
//   block_engine_exit        dx = T((g + c1) + c2*x) over the prefix, from
//                            grad[..., :C0] and buf[..., :C0], into a
//                            contiguous (B, H, W, C0) tensor
//
// and the per-channel glue between those launches (one launch each at
// world size 1; REDUCE and FINISH as two around a process group's
// all-reduce):
//
//   block_engine_glue_fwd    after K4: its partials summed (spread across
//                            the SMs, the chunks' sums summed in order by
//                            the last block of a channel group), /n into
//                            the block's (mu, m2); the next layer's BN fold
//                            and its kernel cast to HWIO in T
//   block_engine_glue_bwd    after K5 and K6: its partials summed into
//                            dgamma, dbeta, dbias; the (C1, C2) update in
//                            place; the previous layer's fold and kernel
//   block_engine_glue_bwd_start  before the top layer: C1, C2 = gmu/n,
//                            2*gm2/n and the top layer's fold and kernel
//   block_engine_running_stats  once a block: every layer's running
//                            statistics, 0.9*r + 0.1*stat
//
// Replaces the Pallas TPU kernels endoscopydepthestimation_pytorch_tpu/ops/
// block_engine.py `_fwd_kernel` (:332, launched by `_layer_fwd` :464),
// `_bwd1_kernel` (:642, `_layer_bwd1` :797) and `_bwd2_kernel` (:919,
// `_layer_bwd2` :1052). None of the TPU layout is carried over (the packed
// (B/8, 8d, H, G, 8b, C) x layout, the packed-96 growth segments and their
// block-tridiagonal weight tables, 128-lane K chunks, VMEM row budgets); the
// single buffer with a channel offset takes the place of the side segments.
// Every cross-block reduction goes through per-block partials summed in a
// fixed order: no atomics, so the BN gradients are the same on every run.
//
// What bounds them on an H100. FCDenseNet-57's 44 layers of one train step
// at 2B = 16, 256x320 take ~392 GFLOP per kernel and move ~4.0 GB (K4, K6)
// and 11.56 GB (K5: the bf16 prefix, and its gradient read and written):
// below the bf16 tensor-core ridge, so memory-bound with tensor cores, at
// ~1.2 ms (K4: 3.97 GB / 3.35 TB/s = 1.18 ms; K6) and 11.56 GB / 3.35 TB/s
// = 3.45 ms (K5; their 392 GFLOP are 0.4 ms at the 989 TFLOP/s bf16 peak).
// In f32 (the parity dtype) all three do their MACs as f32 FFMAs on the
// CUDA cores, which makes them FFMA-bound at ~5.8 ms each (67 TFLOP/s).
// Derived from the shapes, not measured.
//
// Designs (bf16: implicit GEMMs on the tensor cores; f32: direct
// convolution, simple first):
//   K4  bf16 (the train path): the implicit GEMM on the tensor cores of
//       csrc/conv3x3_mma.cuh, shared with K1 (M = 256 pixels, N = 16, K =
//       9 taps x 16-channel chunks, mma.sync m16n8k16, the activated halo
//       built in registers into two shared-memory stages), here reading the
//       prefix at row stride ld, writing y at channel offset C and summing
//       the stored y (STATS). (Holding chunk k+1's loads in registers across
//       chunk k's MMAs was slower: more registers, spills.) Each prefix byte
//       crosses HBM once; the halo's 1.3x re-reads hit L2. Where the image
//       has fewer tiles than the card has SMs (<= 32x40 at 2B = 16) the
//       chunks split evenly across ~256 blocks (the wrapper's choice,
//       measured), summed in split order by the header's finish pass. 47.5
//       KB of static shared memory a block; rows not 16-byte aligned, and an
//       odd C or F, take scalar loads and stores. Bitwise repeatable.
//   K4  f32 (the parity dtype): K1's design (csrc/dense_conv.cu): a 16x32
//       output tile of one image, 128 threads, 4 rows x all F per thread,
//       the (18x34) x 16-channel activated halo in shared memory; plus the
//       prefix stride and the output offset, and a block reduction of the
//       stored y.
//   K5  bf16 (the train path): an implicit GEMM on the tensor cores,
//       M = 256 pixels of one image (8x32, 16x16 or 32x8, the wrapper picks
//       the shape that pads the image least), N = 32 prefix channels,
//       K = 9 taps x 16 (F zero-padded to 16: one k16 step per tap), one
//       block per (tile, channel chunk), 8 warps of 32 pixels x 32 channels,
//       mma.sync m16n8k16 with f32 accumulators. Since it is memory-bound,
//       the design spends its effort on the bytes: the block first starts
//       cp.async copies of its x and gradient tile (16-byte vectors along
//       the channels) into shared memory, then stages the gy_eff halo (bf16,
//       rounded as the plain version rounds it, 48-byte rows so that
//       ldmatrix rows hit distinct banks) and the weight slice [9][32][16],
//       runs the 9 taps from ldmatrix fragments while the copies land, and
//       applies the mask and scale from the fragments, storing the updated
//       gradient as channel pairs straight from them. Each x and gradient byte
//       crosses HBM once; gy and y are re-read from L2 by the few chunk
//       blocks of a tile, which launch next to each other. Rows whose
//       stride or base is not 16-byte aligned, and an odd C or F, take
//       scalar copies instead. Three blocks share an SM (80 registers, 73 KB
//       of shared memory each); a chunk loop with a double-buffered tile at
//       two blocks per SM, and 128-pixel blocks, were both slower.
//       The per-channel sums reduce over lanes, then over warps in shared
//       memory, in a fixed order: one writer per (tile, channel).
//   K5  f32 (the parity dtype; mma has no full-f32 input): the K4 tile; the
//       gy_eff halo (F channels) is loaded ONCE into shared memory and the
//       block then loops over 16-channel chunks of the prefix, each thread
//       accumulating 4 rows x 16 channels over the transposed taps; the
//       epilogue reads x, applies the mask and updates the gradient in
//       place. At the deep levels a grid axis splits the chunks so the card
//       has enough blocks.
//   K6  bf16 (the train path): K4's GEMM with the operands' roles turned
//       around, per tap dW_tap (16 channels x 16 f) += a_tap^T (16 x 256
//       pixels) * gy_eff (256 x 16), mma.sync m16n8k16 with f32
//       accumulators. One block per (16-channel chunk, split) loops over
//       the 256-pixel tiles t = split, split + S, ... (the TPU's sequential
//       grid axis). A tile's MMAs are short (36 a warp), so what bounds the
//       loop is the latency of its loads: the raw prefix halo [pos][16], g
//       and y of each tile go by cp.async into a ring of DW_DEPTH stages,
//       DW_DEPTH - 1 tiles ahead, and land while the block works on the
//       tiles before; an in-place pass then activates the halo and turns g
//       into gy_eff, as the plain version rounds them, zero outside the
//       image, for channels >= C and for f >= F (so the padding adds
//       nothing). Both operands lie pixel-major, so both come through
//       ldmatrix .trans; a tap is a fixed offset from each lane's halo row.
//       8 warps of 32 pixels each hold all 9 x 16 x 16 sums (72 registers
//       a thread) across the tiles, reduce in shared memory in warp order,
//       and the block writes its partial; a second kernel sums the S
//       partials in order. Every chunk block of a tile re-reads its g and y
//       (24 channels), mostly from L2: the chunk blocks of one split run
//       together. (Blocks of two and four chunks, which stage g and y once
//       for them, were slower, and so were 3 and 4 stages; PERF.md §6.)
//   K6  f32 (the parity dtype): an 8x32 tile set per (16-channel chunk,
//       split) block, 192 threads = 16 channels x 3 row taps x 4 row
//       groups; each thread slides a 3-wide window of the activated row
//       over the tile and accumulates 3 x F outputs against gy_eff read as
//       float4 broadcasts, over the same strided tiles; the 4 row groups
//       are reduced in shared memory, and the same second kernel sums the
//       S partials.
//   The boundary (both dtypes, one template): memory-bound passes over the
//       prefix, 4 bytes an element in (read x, write buf) and 6 out (read g
//       and x, write dx) in bf16. A block of 256 threads is `rows` pixels x
//       `lanes` channel vectors; a thread keeps one channel vector of VW
//       channels (16 bytes where C0 and ld are multiples of VW and the bases
//       16-byte aligned, else one channel) and strides over the pixels with
//       grid.x blocks (one wave at 3 an SM), two pixels in flight; the C
//       entries alone pick the vector width and the grid (`boundary_layout`).
//       (At 4 blocks an SM the 64-register cap spilled and both ran 4-10%
//       slower; 4 pixels in flight spilled more and was slower still.)
//       The entry's thread sums x and x^2 in f64 (a 256x320 prefix is 1.3 M
//       pixels: f32 chains lose ~1e-6); the block's rows are summed in row
//       order, the blocks' partials in block order: bitwise repeatable. The
//       exit rounds each step as the plain expression does (__fadd_rn,
//       __fmul_rn: never an FMA), so dx is bitwise the plain version's.
//   The glue (both dtypes; T only for the cast kernel): a few kilobytes of
//       vectors, plus K4's and K5's partials (up to ~16 MB at 256x320, read
//       once). A reduction block takes a chunk of at least 32 rows of one
//       plane's columns of a group of 64 channels, lanes of 256 threads
//       striding the rows (each lane's rows in order, then the lanes in
//       order), writes its sums to a scratch row; about 264 blocks in all.
//       The last block of a group to count itself in (a __device__ counter
//       per group, which that block sets back to 0) sums the scratch rows in
//       chunk order and finishes the group's channels. What waits for no sum
//       (the folds of settled channels, the kernel cast) runs in every
//       block, grid-stride. Every step rounds as PyTorch's CUDA kernels do:
//       separate products and sums, rsqrtf, a division by n as the product
//       with the f32 1/n; so the folds, casts and (C1, C2) updates are bitwise
//       the plain expressions on the card given the same sums.

#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_mma.cuh"  // bf16 K4's body, shared with K1; CC, GP, MMA_HALO

namespace {

constexpr int MAX_GROWTH = 16;

// K4 and f32 K5 tile (the K1 tile)
constexpr int TW = 32;                      // tile width (threads in x)
constexpr int RPT = 4;                      // output rows per thread
constexpr int TY = 4;                       // threads in y
constexpr int TH = TY * RPT;                // tile height
constexpr int NT = TW * TY;                 // threads per block
constexpr int NWARP = NT / 32;
constexpr int HALO = (TH + 2) * (TW + 2);
constexpr int PS = HALO + 1;                // odd pitch: fewer bank conflicts

// K6 tile
constexpr int TW6 = 32;
constexpr int TH6 = 8;
constexpr int Q6 = 4;                       // row groups
constexpr int NT6 = CC * 3 * Q6;            // 192 threads
constexpr int HALO6 = (TH6 + 2) * (TW6 + 2);
constexpr int PS6 = HALO6 + 1;

// bf16 K5 tile
constexpr int M5 = 256;                     // pixels per block
constexpr int N5 = 32;                      // prefix channels per block
constexpr int NT5 = 256;                    // threads: 8 warps x 32 pixels
constexpr int XP = N5 + 8;                  // x and gradient tile pitch (bf16)
constexpr int SMEM5 = 2 * (MMA_HALO * GP + 9 * N5 * GP + 2 * M5 * XP) +
                      4 * (2 * (NT5 / 32) * N5 + 2 * N5);  // + f32 sums, scale, shift

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

// v rounded to T and back: the value a T tensor would hold
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return to_float(from_float<T>(v));
}

// rounded<bf16>(affine_relu(x, scale, shift)) > 0, K5's bf16 ReLU mask,
// without the rounding: a positive f32 rounds to a bf16 0 exactly when it
// is at most 2^-134, half of bf16's least subnormal (the tie goes to 0)
__device__ __forceinline__ bool active_bf16(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift) > 0x1p-134f;
}

// gy_eff = (g + c1) + c2*y, each step rounded as in the plain version
__device__ __forceinline__ float gy_eff(float g, float y, float c1, float c2) {
  return __fadd_rn(__fadd_rn(g, c1), __fmul_rn(c2, y));
}

// ---------------------------------------------------------------------------
// K4: layer forward

template <typename T, int FP>
__global__ void __launch_bounds__(NT) fwd_kernel(
    T* buf, const float* __restrict__ scale, const float* __restrict__ shift,
    const T* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ part, int H, int W, int C, int F, int ld) {
  __shared__ float s_x[CC * PS];
  __shared__ __align__(16) float s_w[9 * CC * FP];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  T* bb = buf + (size_t)blockIdx.z * H * W * ld;

  float acc[RPT][FP];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int f = 0; f < FP; ++f) acc[r][f] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int e = tid; e < HALO * CC; e += NT) {
      const int c = e % CC, pos = e / CC;
      const int gh = h0 + pos / (TW + 2) - 1, gw = w0 + pos % (TW + 2) - 1;
      const int gc = c0 + c;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C) {
        const float t = to_float(bb[((size_t)gh * W + gw) * ld + gc]);
        v = rounded<T>(affine_relu(t, scale[gc], shift[gc]));
      }
      s_x[c * PS + pos] = v;
    }
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

  // store the rounded y; its statistics are those of the stored values
  float s1[FP], s2[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) s1[f] = s2[f] = 0.f;
  const int gw = w0 + tx;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gh = h0 + ty * RPT + r;
    if (gw < W && gh < H) {
      T* yp = bb + ((size_t)gh * W + gw) * ld + C;
#pragma unroll
      for (int f = 0; f < FP; ++f)
        if (f < F) {
          const T yv = from_float<T>(acc[r][f] + bias[f]);
          yp[f] = yv;
          const float yf = to_float(yv);
          s1[f] += yf;
          s2[f] = fmaf(yf, yf, s2[f]);
        }
    }
  }
  // block reduction in a fixed order; s_x is free after the last sync
  float* red = s_x;  // [warp][2][FP]
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    const float a = warp_sum(s1[f]), b = warp_sum(s2[f]);
    if (lane == 0) {
      red[(warp * 2) * FP + f] = a;
      red[(warp * 2 + 1) * FP + f] = b;
    }
  }
  __syncthreads();
  if (tid < 2 * F) {
    const int k = tid / F, f = tid % F;
    float t = 0.f;
    for (int i = 0; i < NWARP; ++i) t += red[(i * 2 + k) * FP + f];
    const size_t nblk = (size_t)gridDim.x * gridDim.y * gridDim.z;
    const size_t sb =
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part[(k * nblk + sb) * F + f] = t;
  }
}

// ---------------------------------------------------------------------------
// K5: input and segment gradients of one layer

template <typename T, int FP>
__global__ void __launch_bounds__(NT) dinput_kernel(
    T* grad, const T* buf, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ w,
    const float* __restrict__ c1, const float* __restrict__ c2,
    float* __restrict__ part, float* __restrict__ part_bias, int B, int H,
    int W, int C, int F, int ld, int n_split, int chunks_per_block) {
  __shared__ float s_g[FP * PS];                    // gy_eff halo [f][pos]
  __shared__ __align__(16) float s_w[9 * FP * CC];  // [tap][f][c]
  __shared__ float s_red[NWARP * 2 * CC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.z % n_split, b = blockIdx.z / n_split;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const size_t img = (size_t)b * H * W * ld;
  T* gb = grad + img;
  const T* bb = buf + img;
  const size_t nsp = (size_t)B * gridDim.y * gridDim.x;
  const size_t sb = ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;

  // gy_eff = g + c1 + c2*y over the halo, zero outside the image; the
  // layer's own channels [C, C+F) are never written by this kernel
  for (int e = tid; e < HALO * FP; e += NT) {
    const int f = e % FP, pos = e / FP;
    const int gh = h0 + pos / (TW + 2) - 1, gw = w0 + pos % (TW + 2) - 1;
    float v = 0.f;
    if (f < F && gh >= 0 && gh < H && gw >= 0 && gw < W) {
      const size_t p = ((size_t)gh * W + gw) * ld + C + f;
      v = rounded<T>(gy_eff(to_float(gb[p]), to_float(bb[p]), c1[f], c2[f]));
    }
    s_g[f * PS + pos] = v;
  }
  __syncthreads();

  if (split == 0) {  // sum gy_eff over the tile (zeros outside the image)
    float db[FP];
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      db[f] = 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        db[f] += s_g[f * PS + (ty * RPT + r + 1) * (TW + 2) + tx + 1];
    }
    float* red = s_red;  // [warp][FP], FP <= 2*CC
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      const float a = warp_sum(db[f]);
      if (lane == 0) red[warp * FP + f] = a;
    }
    __syncthreads();
    if (tid < F) {
      float t = 0.f;
      for (int i = 0; i < NWARP; ++i) t += red[i * FP + tid];
      part_bias[sb * F + tid] = t;
    }
    __syncthreads();
  }

  for (int k = 0; k < chunks_per_block; ++k) {
    const int cc0 = (split * chunks_per_block + k) * CC;
    if (cc0 >= C) break;
    for (int e = tid; e < 9 * FP * CC; e += NT) {
      const int c = e % CC, f = (e / CC) % FP, tap = e / (CC * FP);
      const int gc = cc0 + c;
      s_w[e] = (f < F && gc < C) ? to_float(w[((size_t)tap * C + gc) * F + f])
                                 : 0.f;
    }
    __syncthreads();

    float acc[RPT][CC];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;

#pragma unroll 1
    for (int f = 0; f < FP; ++f) {
      const float* gs = s_g + f * PS + ty * RPT * (TW + 2) + tx;
      float gv[RPT + 2][3];
#pragma unroll
      for (int r = 0; r < RPT + 2; ++r)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) gv[r][kx] = gs[r * (TW + 2) + kx];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // output row r reads gy at halo row r + 2 - ky, column 2 - kx
          const float4* wv = reinterpret_cast<const float4*>(
              s_w + ((ky * 3 + kx) * FP + f) * CC);
          float wr[CC];
#pragma unroll
          for (int q = 0; q < CC / 4; ++q) {
            const float4 t = wv[q];
            wr[4 * q] = t.x;
            wr[4 * q + 1] = t.y;
            wr[4 * q + 2] = t.z;
            wr[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CC; ++c)
              acc[r][c] = fmaf(gv[r + 2 - ky][2 - kx], wr[c], acc[r][c]);
        }
    }

    // mask, scale, in-place gradient update, BN partial sums
    float sx[CC], ss[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) sx[c] = ss[c] = 0.f;
    const int gw = w0 + tx;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int gh = h0 + ty * RPT + r;
      if (gw < W && gh < H) {
        const size_t p = ((size_t)gh * W + gw) * ld + cc0;
#pragma unroll
        for (int c = 0; c < CC; ++c)
          if (cc0 + c < C) {
            const int gc = cc0 + c;
            const float xv = to_float(bb[p + c]);
            const float a = rounded<T>(affine_relu(xv, scale[gc], shift[gc]));
            const float d = a > 0.f ? acc[r][c] : 0.f;
            gb[p + c] = from_float<T>(__fadd_rn(to_float(gb[p + c]), __fmul_rn(d, scale[gc])));
            sx[c] = fmaf(d, xv, sx[c]);
            ss[c] += d;
          }
      }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const float a = warp_sum(sx[c]), d = warp_sum(ss[c]);
      if (lane == 0) {
        s_red[(warp * 2) * CC + c] = a;
        s_red[(warp * 2 + 1) * CC + c] = d;
      }
    }
    __syncthreads();
    if (tid < 2 * CC) {
      const int kk = tid / CC, c = tid % CC;
      if (cc0 + c < C) {
        float t = 0.f;
        for (int i = 0; i < NWARP; ++i) t += s_red[(i * 2 + kk) * CC + c];
        part[(kk * nsp + sb) * C + cc0 + c] = t;
      }
    }
    __syncthreads();  // s_w and s_red are rewritten by the next chunk
  }
}

// ---------------------------------------------------------------------------
// K5 in bf16: the same function as an implicit GEMM on the tensor cores

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// One block: the tile of M5 pixels at (blockIdx.y, image blockIdx.z),
// 1 << TWL wide, and the N5 prefix channels from blockIdx.x * N5. VEC: buf
// and grad rows are 16-byte aligned and C and F are even (ld % 8 == 0,
// aligned bases), so the x and gradient tile move as 16-byte vectors and the
// halo and the weights as channel pairs; else everything moves as scalars
// (with more registers: its staging holds twice the values).
template <int TWL, bool VEC>
__global__ void __launch_bounds__(NT5, VEC ? 3 : 2) dinput_mma_kernel(
    __nv_bfloat16* grad, const __nv_bfloat16* buf,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ c1,
    const float* __restrict__ c2, float* __restrict__ part,
    float* __restrict__ part_bias, int H, int W, int C, int F, int ld) {
  constexpr int TW5 = 1 << TWL, HP = TW5 + 2;  // tile width, halo row pitch
  constexpr int N_HALO = (M5 / TW5 + 2) * HP;  // halo positions
  static_assert(N_HALO <= MMA_HALO, "the halo does not fit its shared memory");
  extern __shared__ __align__(16) unsigned char smem5[];
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(smem5);  // [pos][f]
  __nv_bfloat16* s_w = s_g + MMA_HALO * GP;   // [tap][n][f]
  __nv_bfloat16* s_x = s_w + 9 * N5 * GP;  // [m][n]
  __nv_bfloat16* s_d = s_x + M5 * XP;      // [m][n], the gradient tile
  float* s_red = reinterpret_cast<float*>(s_d + M5 * XP);  // [warp][2][n]
  float* s_ss = s_red + 2 * (NT5 / 32) * N5;               // scale, shift

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_w = (W + TW5 - 1) / TW5;
  const int w0 = (blockIdx.y % tiles_w) * TW5, h0 = (blockIdx.y / tiles_w) * (M5 / TW5);
  const int c0 = blockIdx.x * N5;
  const size_t img = (size_t)blockIdx.z * H * W * ld;
  __nv_bfloat16* gb = grad + img;
  const __nv_bfloat16* bb = buf + img;
  const size_t nsp = (size_t)gridDim.z * gridDim.y;
  const size_t sb = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  // pixel m of the tile: (h0 + m / TW5, w0 + m % TW5)
  auto inside = [&](int m) { return h0 + m / TW5 < H && w0 + m % TW5 < W; };
  auto row = [&](int m) { return ((size_t)(h0 + m / TW5) * W + w0 + m % TW5) * ld; };

  // 1. the x and gradient tile: in flight while the halo is staged and the
  //    MMAs run
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < M5 * (N5 / 8) / NT5; ++k) {
      const int e = tid + k * NT5, m = e / (N5 / 8), v = e % (N5 / 8);
      if (inside(m) && c0 + 8 * v < C) {  // c0 + 8v + 8 <= ld: multiples of 8
        const size_t p = row(m) + c0 + 8 * v;
        cp_async16(smem_addr(s_x + m * XP + 8 * v), bb + p);
        cp_async16(smem_addr(s_d + m * XP + 8 * v), gb + p);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int e = tid; e < M5 * N5; e += NT5) {
      const int m = e / N5, n = e % N5;
      if (inside(m) && c0 + n < C) {
        s_x[m * XP + n] = bb[row(m) + c0 + n];
        s_d[m * XP + n] = gb[row(m) + c0 + n];
      }
    }
  }

  // 2. the weight slice (zero for f >= F and c >= C), the chunk's scale and
  //    shift (zero for c >= C), and g and y of the layer's channels [C, C+F)
  //    over the halo (never written by this kernel), LP lanes per position
  //    and CPL channels per lane: every load is issued before the first
  //    store, so the block waits for one round trip, not one per step
  constexpr int LP = VEC ? 8 : 16, CPL = 16 / LP;
  constexpr int W_STEPS = 9 * N5 * LP / NT5;
  constexpr int G_STEPS = (N_HALO * LP + NT5 - 1) / NT5;
  using G = std::conditional_t<VEC, __nv_bfloat162, __nv_bfloat16>;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int f0 = (tid % LP) * CPL;  // the same at every step: NT5 % LP == 0
  G wv[W_STEPS];
#pragma unroll
  for (int k = 0; k < W_STEPS; ++k) {  // weight (tap, n), channels f0 ..
    const int e = tid / LP + k * (NT5 / LP), n = e % N5, tap = e / N5;
    const size_t p = ((size_t)tap * C + c0 + n) * F + f0;
    if constexpr (VEC) {
      wv[k] = __halves2bfloat162(zero, zero);
      if (f0 < F && c0 + n < C) wv[k] = *reinterpret_cast<const __nv_bfloat162*>(w + p);
    } else {
      wv[k] = zero;
      if (f0 < F && c0 + n < C) wv[k] = w[p];
    }
  }
  float ssv = 0.f;  // scale (tid < N5), shift (N5 <= tid < 2*N5)
  if (tid < 2 * N5 && c0 + tid % N5 < C)
    ssv = (tid < N5 ? scale : shift)[c0 + tid % N5];
  G gr[G_STEPS], yr[G_STEPS];
#pragma unroll
  for (int k = 0; k < G_STEPS; ++k) {
    const int pos = tid / LP + k * (NT5 / LP);
    const int gh = h0 + pos / HP - 1, gw = w0 + pos % HP - 1;
    if constexpr (VEC) gr[k] = yr[k] = __halves2bfloat162(zero, zero);
    else gr[k] = yr[k] = zero;
    if (pos < N_HALO && gh >= 0 && gh < H && gw >= 0 && gw < W && f0 < F) {
      const size_t p = ((size_t)gh * W + gw) * ld + C + f0;
      if constexpr (VEC) {
        gr[k] = *reinterpret_cast<const __nv_bfloat162*>(gb + p);
        yr[k] = *reinterpret_cast<const __nv_bfloat162*>(bb + p);
      } else {
        gr[k] = gb[p];
        yr[k] = bb[p];
      }
    }
  }
  float c1v[CPL], c2v[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    c1v[j] = f0 + j < F ? c1[f0 + j] : 0.f;
    c2v[j] = f0 + j < F ? c2[f0 + j] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < W_STEPS; ++k)  // [tap][n][f]: tid / LP + k * (NT5 / LP) = tap*N5 + n
    *reinterpret_cast<G*>(s_w + (tid / LP + k * (NT5 / LP)) * GP + f0) = wv[k];
  if (tid < 2 * N5) s_ss[tid] = ssv;
  // 3. gy_eff = g + c1 + c2*y over the halo, rounded to bf16, zero outside
  //    the image and for f >= F
#pragma unroll
  for (int k = 0; k < G_STEPS; ++k) {
    const int pos = tid / LP + k * (NT5 / LP);
    const int gh = h0 + pos / HP - 1, gw = w0 + pos % HP - 1;
    if (pos < N_HALO) {
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      float v[CPL];
      if constexpr (VEC) {
        const float2 g2 = __bfloat1622float2(gr[k]), y2 = __bfloat1622float2(yr[k]);
        v[0] = gy_eff(g2.x, y2.x, c1v[0], c2v[0]);
        v[1] = gy_eff(g2.y, y2.y, c1v[1], c2v[1]);
      } else {
        v[0] = gy_eff(to_float(gr[k]), to_float(yr[k]), c1v[0], c2v[0]);
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (!in || f0 + j >= F) v[j] = 0.f;
      if constexpr (VEC)
        *reinterpret_cast<__nv_bfloat162*>(s_g + pos * GP + f0) =
            __floats2bfloat162_rn(v[0], v[1]);
      else
        s_g[pos * GP + f0] = __float2bfloat16(v[0]);
    }
  }
  __syncthreads();

  if (blockIdx.x == 0) {  // sum gy_eff over the tile (zeros outside the image)
    const int f = tid % 16;
    float s = 0.f;
#pragma unroll 4
    for (int m = tid / 16; m < M5; m += NT5 / 16)
      s += to_float(s_g[((m / TW5 + 1) * HP + m % TW5 + 1) * GP + f]);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 16) s_red[warp * 16 + lane] = s;
    __syncthreads();
    if (tid < F) {
      float t = 0.f;
      for (int i = 0; i < NT5 / 32; ++i) t += s_red[i * 16 + tid];
      part_bias[sb * F + tid] = t;
    }
  }

  // 4. the GEMM: warp w owns pixels [32w, 32w + 32) as two m16 tiles and all
  //    N5 channels as four n8 tiles. Output pixel (r, x) of tap (ky, kx)
  //    reads gy_eff at halo position (r + 2 - ky, x + 2 - kx); the tap's B
  //    is W[ky, kx, c, 0:16], [n][k] in shared memory as mma's col operand.
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  unsigned a_base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // ldmatrix row: pixel lane % 16, k half lane / 16
    const int m = warp * 32 + i * 16 + lane % 16;
    a_base[i] = smem_addr(s_g + ((m / TW5) * HP + m % TW5) * GP + (lane / 16) * 8);
  }
  // B rows: channel (lane / 16) * 8 + lane % 8 of a 16-channel pair, k half (lane / 8) % 2
  const unsigned b_base =
      smem_addr(s_w + ((lane / 16) * 8 + lane % 8) * GP + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a_base[i] + 2 * GP * ((2 - ky) * HP + 2 - kx), a[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(b_base + 2 * GP * ((ky * 3 + kx) * N5 + 16 * j), b[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[i][nt], a[i], b[nt / 2][(nt % 2) * 2], b[nt / 2][(nt % 2) * 2 + 1]);
    }

  // 5. epilogue from the fragments: thread (g, t) = (lane / 4, lane % 4)
  //    holds pixels row0 + g (accumulators 0, 1) and row0 + 8 + g (2, 3) of
  //    each m16 tile and the channel pair nt*8 + 2t + {0, 1}: mask, scale,
  //    the gradient update, stored in place as channel pairs (the four lanes
  //    of a pixel write 16 contiguous bytes), and the per-channel sums. A
  //    channel >= C has scale = shift = 0, so its mask is 0 and d = 0; it is
  //    never stored.
  if constexpr (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int g = lane / 4, t = lane % 4;
  float2 sx[4], ss[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) sx[nt] = ss[nt] = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp * 32 + i * 16 + half * 8 + g;
      if (inside(m)) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int o = m * XP + nt * 8 + 2 * t;
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_x + o));
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_d + o));
          const float2 sc = *reinterpret_cast<const float2*>(s_ss + nt * 8 + 2 * t);
          const float2 sh = *reinterpret_cast<const float2*>(s_ss + N5 + nt * 8 + 2 * t);
          const float d0 = active_bf16(xv.x, sc.x, sh.x) ? acc[i][nt][2 * half] : 0.f;
          const float d1 = active_bf16(xv.y, sc.y, sh.y) ? acc[i][nt][2 * half + 1] : 0.f;
          const __nv_bfloat162 nv = __floats2bfloat162_rn(
              __fadd_rn(gv.x, __fmul_rn(d0, sc.x)), __fadd_rn(gv.y, __fmul_rn(d1, sc.y)));
          const int gc = c0 + nt * 8 + 2 * t;
          if constexpr (VEC) {
            if (gc < C) *reinterpret_cast<__nv_bfloat162*>(gb + row(m) + gc) = nv;
          } else {
            if (gc < C) gb[row(m) + gc] = nv.x;
            if (gc + 1 < C) gb[row(m) + gc + 1] = nv.y;
          }
          sx[nt].x = fmaf(d0, xv.x, sx[nt].x);
          sx[nt].y = fmaf(d1, xv.y, sx[nt].y);
          ss[nt].x += d0;
          ss[nt].y += d1;
        }
      }
    }
  // over the 8 lanes of one channel, then over the warps in order
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = j ? sx[nt].y : sx[nt].x, d = j ? ss[nt].y : ss[nt].x;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        d += __shfl_xor_sync(0xffffffffu, d, o);
      }
      if (g == 0) {
        const int n = nt * 8 + 2 * t + j;
        s_red[(warp * 2) * N5 + n] = a;
        s_red[(warp * 2 + 1) * N5 + n] = d;
      }
    }
  __syncthreads();
  if (tid < 2 * N5) {
    const int k = tid / N5, n = tid % N5;
    if (c0 + n < C) {
      float s = 0.f;
      for (int i = 0; i < NT5 / 32; ++i) s += s_red[(i * 2 + k) * N5 + n];
      part[(k * nsp + sb) * C + c0 + n] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K6: weight gradients of one layer

template <int FP>
struct DweightSmem {
  static constexpr int A = CC * PS6;            // activated halo [c][pos]
  static constexpr int A4 = (A + 3) / 4 * 4;    // 16-byte aligned s_g
  static constexpr int G = TH6 * TW6 * FP;      // gy_eff tile [pix][f]
  static constexpr int RED = Q6 * CC * 9 * FP;  // [q][c][tap][f]
  static constexpr int SIZE = (A4 + G > RED) ? A4 + G : RED;
};

template <typename T, int FP>
__global__ void __launch_bounds__(NT6) dweight_kernel(
    const T* grad, const T* buf, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ c1,
    const float* __restrict__ c2, float* __restrict__ part, int B, int H,
    int W, int C, int F, int ld) {
  using S = DweightSmem<FP>;
  __shared__ __align__(16) float smem[S::SIZE];
  float* s_a = smem;
  float* s_g = smem + S::A4;

  const int tid = threadIdx.x;
  const int c = tid % CC, ky = (tid / CC) % 3, q = tid / (3 * CC);
  const int cc0 = blockIdx.x * CC;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int tiles_w = (W + TW6 - 1) / TW6, tiles_h = (H + TH6 - 1) / TH6;
  const int n_tiles = B * tiles_h * tiles_w;

  float acc[3][FP];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int f = 0; f < FP; ++f) acc[kx][f] = 0.f;

  for (int t = split; t < n_tiles; t += n_split) {
    const int w0 = (t % tiles_w) * TW6;
    const int h0 = ((t / tiles_w) % tiles_h) * TH6;
    const size_t img = (size_t)(t / (tiles_w * tiles_h)) * H * W * ld;
    const T* bb = buf + img;
    const T* gb = grad + img;
    for (int e = tid; e < HALO6 * CC; e += NT6) {
      const int cc = e % CC, pos = e / CC;
      const int gh = h0 + pos / (TW6 + 2) - 1, gw = w0 + pos % (TW6 + 2) - 1;
      const int gc = cc0 + cc;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C) {
        const float x = to_float(bb[((size_t)gh * W + gw) * ld + gc]);
        v = rounded<T>(affine_relu(x, scale[gc], shift[gc]));
      }
      s_a[cc * PS6 + pos] = v;
    }
    for (int e = tid; e < TH6 * TW6 * FP; e += NT6) {
      const int f = e % FP, pix = e / FP;
      const int gh = h0 + pix / TW6, gw = w0 + pix % TW6;
      float v = 0.f;
      if (f < F && gh < H && gw < W) {
        const size_t p = ((size_t)gh * W + gw) * ld + C + f;
        v = rounded<T>(gy_eff(to_float(gb[p]), to_float(bb[p]), c1[f], c2[f]));
      }
      s_g[pix * FP + f] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int hr = 0; hr < TH6 / Q6; ++hr) {
      const int h = q * (TH6 / Q6) + hr;
      const float* arow = s_a + c * PS6 + (h + ky) * (TW6 + 2);
      float a0 = arow[0], a1 = arow[1];
#pragma unroll 4
      for (int x = 0; x < TW6; ++x) {
        const float a2 = arow[x + 2];
        const float4* gv = reinterpret_cast<const float4*>(s_g + (h * TW6 + x) * FP);
        float gr[FP];
#pragma unroll
        for (int i = 0; i < FP / 4; ++i) {
          const float4 v = gv[i];
          gr[4 * i] = v.x;
          gr[4 * i + 1] = v.y;
          gr[4 * i + 2] = v.z;
          gr[4 * i + 3] = v.w;
        }
#pragma unroll
        for (int f = 0; f < FP; ++f) {
          acc[0][f] = fmaf(a0, gr[f], acc[0][f]);
          acc[1][f] = fmaf(a1, gr[f], acc[1][f]);
          acc[2][f] = fmaf(a2, gr[f], acc[2][f]);
        }
        a0 = a1;
        a1 = a2;
      }
    }
    __syncthreads();
  }

  // reduce the row groups in shared memory (free after the last sync)
  float* red = smem;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int f = 0; f < FP; ++f)
      red[((q * CC + c) * 9 + ky * 3 + kx) * FP + f] = acc[kx][f];
  __syncthreads();
  for (int e = tid; e < CC * 9 * F; e += NT6) {
    const int f = e % F, tap = (e / F) % 9, cc = e / (9 * F);
    if (cc0 + cc < C) {
      float s = 0.f;
      for (int i = 0; i < Q6; ++i) s += red[((i * CC + cc) * 9 + tap) * FP + f];
      part[(((size_t)split * 9 + tap) * C + cc0 + cc) * F + f] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K6 in bf16: the same function as an implicit GEMM on the tensor cores

constexpr int DW_THREADS = 256;  // 8 warps x 32 pixels of a 256-pixel tile
constexpr int DW_DEPTH = 2;      // the ring's stages: tiles whose copies are in flight
constexpr int DW_YP = MMA_N;     // y's row pitch (bf16): read by no ldmatrix
// a stage: the chunk's raw halo [pos][c] (activated in place), the tile's g
// [pix][f] (gy_eff in place), both at the GP pitch, and its y [pix][f]
constexpr int DW_STAGE = 2 * (MMA_HALO * GP + MMA_PIXELS * (GP + DW_YP));  // bytes
// the ring, then scale, shift (the chunk's) and c1, c2 (f32); the f32 sums
// [tap][c][f] reuse the ring at the end
constexpr int DW_SMEM = DW_DEPTH * DW_STAGE + 4 * 4 * CC;
static_assert(DW_STAGE % 16 == 0 && DW_DEPTH >= 2, "stages hold 16-byte copies");
static_assert(DW_DEPTH * DW_STAGE >= 4 * 9 * CC * MMA_N, "the sums do not fit the ring");

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One block: the 16 prefix channels from blockIdx.x * 16 over the tiles
// t = split, split + S, ... (split = blockIdx.y of S = gridDim.y) of 256
// pixels, 1 << TWL wide. VW = 8: buf and grad rows 16-byte aligned (ld % 8
// == 0, aligned bases) and C, F multiples of 4, so the prefix moves as
// 16-byte cp.async copies and g, y as 8-byte ones (a vector that starts
// below C + F ends at or before it); VW = 1: scalar loads and stores.
template <int TWL, int VW>
__global__ void __launch_bounds__(DW_THREADS, VW > 1 ? 2 : 1) dweight_mma_kernel(
    const __nv_bfloat16* grad, const __nv_bfloat16* buf,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ c1, const float* __restrict__ c2,
    float* __restrict__ part, int B, int H, int W, int C, int F, int ld) {
  static_assert(VW == 8 || VW == 1, "a lane moves 8 prefix channels or 1");
  constexpr int TW = 1 << TWL, TH = MMA_PIXELS / TW, HP = TW + 2;
  constexpr int N_HALO = (TH + 2) * HP;  // halo positions
  static_assert(N_HALO <= MMA_HALO, "the halo does not fit its shared memory");
  constexpr int VG = VW > 1 ? 4 : 1;           // g and y channels a lane moves
  constexpr int LP = CC / VW, LG = MMA_N / VG;  // lanes a halo position, a pixel
  constexpr int A_STEPS = (N_HALO * LP + DW_THREADS - 1) / DW_THREADS;
  constexpr int G_STEPS = MMA_PIXELS * LG / DW_THREADS;
  extern __shared__ __align__(16) unsigned char smem6[];
  auto s_a = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem6 + st * DW_STAGE); };
  auto s_g = [&](int st) { return s_a(st) + MMA_HALO * GP; };
  auto s_y = [&](int st) { return s_g(st) + MMA_PIXELS * GP; };
  float* s_par = reinterpret_cast<float*>(smem6 + DW_DEPTH * DW_STAGE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * CC, split = blockIdx.y, n_split = gridDim.y;
  const int tiles_w = (W + TW - 1) / TW, tiles_img = ((H + TH - 1) / TH) * tiles_w;
  const int n_tiles = B * tiles_img;
  // scale, shift (zero for channels >= C), c1, c2 (zero for f >= F); first
  // read after the loop's first barrier
  if (tid < 2 * CC) {
    const int i = tid % CC;
    const bool lo = tid < CC;
    s_par[tid] = c0 + i < C ? (lo ? scale : shift)[c0 + i] : 0.f;
    s_par[2 * CC + tid] = i < F ? (lo ? c1 : c2)[i] : 0.f;
  }

  // Lane roles, the same for every tile: halo position tid / LP + k *
  // (DW_THREADS / LP) and channels ch0 .. ch0 + VW; pixel tid / LG + k *
  // (DW_THREADS / LG) and f f0 .. f0 + VG. A lane transforms what it copied.
  const int ch0 = (tid % LP) * VW, f0 = (tid % LG) * VG;
  const int nv = C - c0 - ch0;  // the lane's prefix channels below C
  struct Tile { int h0, w0; size_t img; };
  auto tile = [&](int t) {
    const int ti = t % tiles_img;
    return Tile{(ti / tiles_w) * TH, (ti % tiles_w) * TW, (size_t)(t / tiles_img) * H * W * ld};
  };
  auto halo_in = [&](const Tile& o, int pos) {
    const int gh = o.h0 + pos / HP - 1, gw = o.w0 + pos % HP - 1;
    return pos < N_HALO && gh >= 0 && gh < H && gw >= 0 && gw < W;
  };
  auto pixel_in = [&](const Tile& o, int m) { return o.h0 + m / TW < H && o.w0 + m % TW < W; };
  auto halo_row = [&](const Tile& o, int pos) {
    return (int)((o.h0 + pos / HP - 1) * W + o.w0 + pos % HP - 1) * ld;
  };
  auto pixel_row = [&](const Tile& o, int m) {
    return (int)((o.h0 + m / TW) * W + o.w0 + m % TW) * ld;
  };

  // 1. tile t's raw prefix halo, g and y into stage st, as copies in flight
  //    (VW = 8) or loads then stores (VW = 1). What lies outside the image,
  //    in channels >= C or in f >= F is not copied: step 2 zeroes it by a
  //    select (for VW = 8 a halo vector may reach into [C, C+F), this
  //    layer's own y, which step 2 zeroes too).
  auto copy_tile = [&](int t, int st) {
    const Tile o = tile(t);
    const __nv_bfloat16* bb = buf + o.img;
    const __nv_bfloat16* gb = grad + o.img;
    if constexpr (VW == 8) {
#pragma unroll
      for (int k = 0; k < A_STEPS; ++k) {
        const int pos = tid / LP + k * (DW_THREADS / LP);
        if (halo_in(o, pos) && nv > 0)
          cp_async16(smem_addr(s_a(st) + pos * GP + ch0), bb + halo_row(o, pos) + c0 + ch0);
      }
#pragma unroll
      for (int k = 0; k < G_STEPS; ++k) {
        const int m = tid / LG + k * (DW_THREADS / LG);
        if (pixel_in(o, m) && f0 < F) {
          const int p = pixel_row(o, m) + C + f0;
          cp_async8(smem_addr(s_g(st) + m * GP + f0), gb + p);
          cp_async8(smem_addr(s_y(st) + m * DW_YP + f0), bb + p);
        }
      }
    } else {
      __nv_bfloat16 ra[A_STEPS], rg[G_STEPS], ry[G_STEPS];
#pragma unroll
      for (int k = 0; k < A_STEPS; ++k) {
        const int pos = tid / LP + k * (DW_THREADS / LP);
        if (halo_in(o, pos) && nv > 0) ra[k] = bb[halo_row(o, pos) + c0 + ch0];
      }
#pragma unroll
      for (int k = 0; k < G_STEPS; ++k) {
        const int m = tid / LG + k * (DW_THREADS / LG);
        if (pixel_in(o, m) && f0 < F) {
          rg[k] = gb[pixel_row(o, m) + C + f0];
          ry[k] = bb[pixel_row(o, m) + C + f0];
        }
      }
#pragma unroll
      for (int k = 0; k < A_STEPS; ++k) {
        const int pos = tid / LP + k * (DW_THREADS / LP);
        if (halo_in(o, pos) && nv > 0) s_a(st)[pos * GP + ch0] = ra[k];
      }
#pragma unroll
      for (int k = 0; k < G_STEPS; ++k) {
        const int m = tid / LG + k * (DW_THREADS / LG);
        if (pixel_in(o, m) && f0 < F) {
          s_g(st)[m * GP + f0] = rg[k];
          s_y(st)[m * DW_YP + f0] = ry[k];
        }
      }
    }
  };

  // 2. in place: the halo activated as the plain version rounds it, zero
  //    outside the image and for channels >= C; gy_eff (rounded likewise)
  //    over g, zero outside the image and for f >= F, so the padding of the
  //    pixel (K) and f (N) dimensions adds nothing.
  const float* s_sc = s_par;
  const float* s_sh = s_par + CC;
  const float* s_c1 = s_par + 2 * CC;
  const float* s_c2 = s_par + 3 * CC;
  auto transform = [&](int t, int st) {
    const Tile o = tile(t);
#pragma unroll
    for (int k = 0; k < A_STEPS; ++k) {
      const int pos = tid / LP + k * (DW_THREADS / LP);
      if (pos >= N_HALO) continue;
      const bool in = halo_in(o, pos);
      __nv_bfloat16* pa = s_a(st) + pos * GP + ch0;
      if constexpr (VW == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(pa);
        const unsigned r[4] = {raw.x, raw.y, raw.z, raw.w};
        unsigned out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = bf2_to_f2(r[q]);
          const int j = ch0 + 2 * q;
          const float a0 = in && 2 * q < nv ? affine_relu(v.x, s_sc[j], s_sh[j]) : 0.f;
          const float a1 = in && 2 * q + 1 < nv ? affine_relu(v.y, s_sc[j + 1], s_sh[j + 1]) : 0.f;
          out[q] = f2_to_bf2(a0, a1);
        }
        *reinterpret_cast<uint4*>(pa) = make_uint4(out[0], out[1], out[2], out[3]);
      } else {
        const float a = in && nv > 0 ? affine_relu(__bfloat162float(*pa), s_sc[ch0], s_sh[ch0]) : 0.f;
        *pa = __float2bfloat16(a);
      }
    }
#pragma unroll
    for (int k = 0; k < G_STEPS; ++k) {
      const int m = tid / LG + k * (DW_THREADS / LG);
      const bool in = pixel_in(o, m);
      __nv_bfloat16* pg = s_g(st) + m * GP + f0;
      const __nv_bfloat16* py = s_y(st) + m * DW_YP + f0;
      if constexpr (VG == 4) {
        const uint2 gr = *reinterpret_cast<const uint2*>(pg);
        const uint2 yr = *reinterpret_cast<const uint2*>(py);
        const float2 ga = bf2_to_f2(gr.x), gc = bf2_to_f2(gr.y);
        const float2 ya = bf2_to_f2(yr.x), yc = bf2_to_f2(yr.y);
        const float gs[4] = {ga.x, ga.y, gc.x, gc.y}, ys[4] = {ya.x, ya.y, yc.x, yc.y};
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = in && f0 + j < F ? gy_eff(gs[j], ys[j], s_c1[f0 + j], s_c2[f0 + j]) : 0.f;
        *reinterpret_cast<uint2*>(pg) = make_uint2(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]));
      } else {
        const float v = in && f0 < F ? gy_eff(__bfloat162float(*pg), __bfloat162float(*py),
                                              s_c1[f0], s_c2[f0]) : 0.f;
        *pg = __float2bfloat16(v);
      }
    }
  };

  // 3. The GEMM, per tap: dW_tap (16 channels x 16 f) += a_tap^T (16 x 256
  //    pixels) * gy_eff (256 x 16). Warp w takes pixels [32w, 32w + 32) of
  //    each tile as two k16 steps and holds all 9 x 16 x 16 sums (72
  //    registers a thread). Both operands lie pixel-major in shared memory,
  //    so both come through ldmatrix .trans. A: lane l addresses pixel
  //    (l / 16) * 8 + l % 8 of the step and channels ((l / 8) % 2) * 8; tap
  //    (ky, kx) reads halo position (m / TW + ky) * HP + m % TW + kx, a fixed
  //    offset from the lane's row. B: lane l addresses pixel ((l / 8) % 2) *
  //    8 + l % 8 and f (l / 16) * 8, giving b0, b1 of the first n8 tile,
  //    then of the second.
  unsigned a_base[2], g_base[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ma = warp * 32 + s * 16 + (lane / 16) * 8 + lane % 8;
    a_base[s] = smem_addr(s_a(0) + ((ma / TW) * HP + ma % TW) * GP + ((lane / 8) % 2) * 8);
    const int mg = warp * 32 + s * 16 + ((lane / 8) % 2) * 8 + lane % 8;
    g_base[s] = smem_addr(s_g(0) + mg * GP + (lane / 16) * 8);
  }
  float acc[9][2][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[tap][nt][k] = 0.f;

  // The ring: tiles split + j * S for j < DW_DEPTH - 1 first, then at each
  // tile the one DW_DEPTH - 1 tiles ahead, into the stage the previous tile
  // used. One copy group a tile (empty past the last), so the wait count
  // is the same at every tile. Two barriers a tile.
#pragma unroll
  for (int j = 0; j < DW_DEPTH - 1; ++j) {
    if (split + j * n_split < n_tiles) copy_tile(split + j * n_split, j);
    cp_async_commit();
  }
  int st = 0;
  for (int t = split; t < n_tiles; t += n_split) {
    cp_async_wait<DW_DEPTH - 2>();  // this lane's copies of tile t landed
    __syncthreads();  // ... and every lane's; the previous tile's MMAs are done
    const int ahead = t + (DW_DEPTH - 1) * n_split;
    if (ahead < n_tiles) copy_tile(ahead, st == 0 ? DW_DEPTH - 1 : st - 1);
    cp_async_commit();
    transform(t, st);
    __syncthreads();
    const unsigned off = st * DW_STAGE;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      unsigned b[4];
      ldmatrix_x4_trans(g_base[s] + off, b);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          unsigned a[4];
          ldmatrix_x4_trans(a_base[s] + off + 2 * GP * (ky * HP + kx), a);
          mma_bf16(acc[ky * 3 + kx][0], a, b[0], b[1]);
          mma_bf16(acc[ky * 3 + kx][1], a, b[2], b[3]);
        }
    }
    st = st == DW_DEPTH - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();

  // 4. The warps' sums into s_red [tap][c][f] in warp order (thread (g, q)
  //    = (lane / 4, lane % 4) holds channels g, g + 8 and f nt*8 + 2q +
  //    {0, 1}), then the block's partial for c < C, f < F. No atomics:
  //    bitwise repeatable.
  float* s_red = reinterpret_cast<float*>(smem6);
  const int g = lane / 4, q = lane % 4;
  for (int w = 0; w < DW_THREADS / 32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* p = reinterpret_cast<float2*>(
                s_red + (tap * CC + half * 8 + g) * MMA_N + nt * 8 + 2 * q);
            float2 v = make_float2(acc[tap][nt][2 * half], acc[tap][nt][2 * half + 1]);
            if (w > 0) {
              const float2 old = *p;
              v = make_float2(old.x + v.x, old.y + v.y);
            }
            *p = v;
          }
    }
    __syncthreads();
  }
  for (int e = tid; e < 9 * CC * MMA_N; e += DW_THREADS) {
    const int f = e % MMA_N, c = (e / MMA_N) % CC, tap = e / (CC * MMA_N);
    if (f < F && c0 + c < C)
      part[(((size_t)split * 9 + tap) * C + c0 + c) * F + f] = s_red[e];
  }
}

// out[i] = sum over s of part[s][i], in order
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int S, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * N + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// The block's boundary: the entry (x into buf, x's moments) and the exit (dx)

constexpr int NTB = 256;              // threads a boundary block
constexpr int BOUNDARY_UNROLL = 2;    // pixels a thread has in flight

// VW elements of T, loaded and stored as one vector (16 bytes for VW > 1)
template <typename T, int VW> struct alignas(sizeof(T) * VW) Vec { T v[VW]; };

// thread (row, lane) of block (bx, by) takes the channel vector by*lanes +
// lane, at the pixels bx*rows + row, then gridDim.x*rows further on, ...
// Its first channel, or C0 where the thread has no vector.
__device__ __forceinline__ int boundary_channel(int C0, int VW, int lanes, int rows) {
  const int lane = threadIdx.x % lanes, row = threadIdx.x / lanes;
  const int c = (blockIdx.y * lanes + lane) * VW;
  return row < rows && c < C0 ? c : C0;
}

template <typename T, int VW>
__global__ void __launch_bounds__(NTB, 3) boundary_entry_kernel(
    const T* __restrict__ x, T* __restrict__ buf, double* __restrict__ part, long long P,
    int C0, int ld, int lanes, int rows) {
  __shared__ double s_sum[NTB * 2 * VW];  // [thread][sum, sum of squares][VW]
  const int c = boundary_channel(C0, VW, lanes, rows);
  double s1[VW], s2[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s1[k] = s2[k] = 0.0;
  if (c < C0) {
    const long long step = (long long)gridDim.x * rows;
    for (long long p = (long long)blockIdx.x * rows + threadIdx.x / lanes; p < P;
         p += BOUNDARY_UNROLL * step) {
      Vec<T, VW> v[BOUNDARY_UNROLL];
#pragma unroll
      for (int u = 0; u < BOUNDARY_UNROLL; ++u)
        if (p + u * step < P)
          v[u] = *reinterpret_cast<const Vec<T, VW>*>(x + (p + u * step) * C0 + c);
#pragma unroll
      for (int u = 0; u < BOUNDARY_UNROLL; ++u)
        if (p + u * step < P) {
          *reinterpret_cast<Vec<T, VW>*>(buf + (p + u * step) * ld + c) = v[u];
#pragma unroll
          for (int k = 0; k < VW; ++k) {
            const double d = to_float(v[u].v[k]);
            s1[k] += d;
            s2[k] = fma(d, d, s2[k]);  // a float's square is exact in f64
          }
        }
    }
  }
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    s_sum[threadIdx.x * 2 * VW + k] = s1[k];
    s_sum[threadIdx.x * 2 * VW + VW + k] = s2[k];
  }
  __syncthreads();
  // the block's partial per (statistic, channel): its rows in order
  for (int e = threadIdx.x; e < 2 * lanes * VW; e += NTB) {
    const int stat = e / (lanes * VW), lc = e % (lanes * VW);
    const int ch = blockIdx.y * lanes * VW + lc;
    if (ch >= C0) continue;
    double s = 0.0;
    for (int r = 0; r < rows; ++r)
      s += s_sum[(r * lanes + lc / VW) * 2 * VW + stat * VW + lc % VW];
    part[((long long)stat * C0 + ch) * gridDim.x + blockIdx.x] = s;
  }
}

// out[k] = (sum over the n_blocks partials part[k][b]) / n, one block a k
// in [0, 2*C0): each thread sums its strided partials in order, then a
// fixed tree over the threads
__global__ void __launch_bounds__(NTB) boundary_entry_finish_kernel(
    const double* __restrict__ part, float* __restrict__ out, int n_blocks, double n) {
  __shared__ double s_red[NTB];
  const double* row = part + (long long)blockIdx.x * n_blocks;
  double s = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += NTB) s += row[b];
  s_red[threadIdx.x] = s;
  __syncthreads();
  for (int h = NTB / 2; h > 0; h /= 2) {
    if (threadIdx.x < h) s_red[threadIdx.x] += s_red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = (float)(s_red[0] / n);
}

// dx[p, c] = T((g + c1[c]) + c2[c]*x) with g, x the prefix of grad, buf
template <typename T, int VW>
__global__ void __launch_bounds__(NTB, 3) boundary_exit_kernel(
    const T* __restrict__ grad, const T* __restrict__ buf, const float* __restrict__ c1,
    const float* __restrict__ c2, T* __restrict__ dx, long long P, int C0, int ld,
    int lanes, int rows) {
  const int c = boundary_channel(C0, VW, lanes, rows);
  if (c >= C0) return;
  float a[VW], b[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    a[k] = c1[c + k];
    b[k] = c2[c + k];
  }
  const long long step = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / lanes; p < P;
       p += BOUNDARY_UNROLL * step) {
    Vec<T, VW> g[BOUNDARY_UNROLL], xv[BOUNDARY_UNROLL];
#pragma unroll
    for (int u = 0; u < BOUNDARY_UNROLL; ++u)
      if (p + u * step < P) {
        g[u] = *reinterpret_cast<const Vec<T, VW>*>(grad + (p + u * step) * ld + c);
        xv[u] = *reinterpret_cast<const Vec<T, VW>*>(buf + (p + u * step) * ld + c);
      }
#pragma unroll
    for (int u = 0; u < BOUNDARY_UNROLL; ++u)
      if (p + u * step < P) {
        Vec<T, VW> out;
#pragma unroll
        for (int k = 0; k < VW; ++k)
          out.v[k] = from_float<T>(gy_eff(to_float(g[u].v[k]), to_float(xv[u].v[k]), a[k], b[k]));
        *reinterpret_cast<Vec<T, VW>*>(dx + (p + u * step) * C0 + c) = out;
      }
  }
}

// ---------------------------------------------------------------------------
// The glue between a block's launches: the per-channel vector math of its
// layers (the statistics from K4's sums, the BN folds, the weight casts, the
// BN gradients and the (C1, C2) updates from K5's sums, the running
// statistics). Every step is rounded as the plain PyTorch expression on the
// card rounds it (__fmul_rn, __fadd_rn, __fsub_rn: never an FMA; a division
// by the pixel count n is a product with the f32 1/n, as PyTorch's CUDA
// division by a scalar computes it).

constexpr int NTG = 256;           // threads a glue block
constexpr int GLUE_BLOCKS = 264;   // a reduction's blocks, at most about (2 an SM)
constexpr int GLUE_ROWS = 32;      // partial rows a reduction block takes, at least
constexpr int GLUE_WIDTH = 64;     // channels a group of a reduction, at most
constexpr int GLUE_GROUPS = 64;    // groups a reduction, at most: 63 of channels + the bias's
constexpr int GLUE_CHANNELS = (GLUE_GROUPS - 1) * GLUE_WIDTH;  // a reduction's, at most
constexpr int GLUE_REDUCE = 1, GLUE_FINISH = 2, GLUE_HEAD = 4;  // the kernels' phases
constexpr float GLUE_EPS = 1e-5f;  // BatchNorm's

// blocks of each group of a reduction that have finished, per direction;
// the group's last block sets its count back to 0 for the next launch. So
// two glue reductions of one direction on one device must never overlap:
// the engine issues every launch on one stream (ops/block_engine.py,
// `_glue_launch`), and a launch on a second stream that overlaps one of the
// first would mix the two counts
__device__ unsigned int glue_arrivals[2][GLUE_GROUPS];

// A reduction of per-tile partials: planes 0 and 1 (n_part, nc) each (the
// sums of K4 or K5 for nc channels) and plane 2 (n_part, nb) (K5's bias
// sums; nb = 0 in the forward). Group g < groups takes the columns [g*width,
// (g+1)*width) of planes 0 and 1, group `groups` plane 2; a segment is one
// plane's part of a group, grid.y; grid.x splits the rows into chunks of
// `rows`. scratch: (chunks, 2*nc + nb) float32, the chunks' sums.
struct GlueLayout {
  int groups, width, segments, chunks, rows;
};

// The fold of a layer's BatchNorm over its prefix [0, c) into (scale,
// shift), and its kernel cast to the buffer's type: w_in[ky, kx, c, f] at
// element strides s0..s3 (float32) into w_out (3, 3, c, F), contiguous. c = 0:
// no layer.
struct GlueFold {
  const float* gamma;
  const float* beta;
  float* scale;
  float* shift;
  const float* w_in;
  void* w_out;
  int c, F, s0, s1, s2, s3;
};

// 1/sqrt(var + eps) with var = m2 - mu^2: the fold's and dgamma's
__device__ __forceinline__ float bn_inv(float mu, float m2) {
  return rsqrtf(__fadd_rn(__fsub_rn(m2, __fmul_rn(mu, mu)), GLUE_EPS));
}

__device__ __forceinline__ void fold_channel(const GlueFold& f, const float* mu,
                                             const float* m2, int ch) {
  const float scale = __fmul_rn(f.gamma[ch], bn_inv(mu[ch], m2[ch]));
  f.scale[ch] = scale;
  f.shift[ch] = __fsub_rn(f.beta[ch], __fmul_rn(mu[ch], scale));
}

template <typename T>
__device__ void cast_weights(const GlueFold& f, long long first, long long step) {
  const int n = 9 * f.c * f.F;  // below 2^31: the C entries check it
  T* out = static_cast<T*>(f.w_out);
  for (long long i = first; i < n; i += step) {
    const int o = (int)i % f.F, c = (int)i / f.F % f.c, tap = (int)i / (f.F * f.c);
    out[i] = from_float<T>(f.w_in[(long long)(tap / 3) * f.s0 + (tap % 3) * f.s1 +
                                  (long long)c * f.s2 + (long long)o * f.s3]);
  }
}

// this thread's index over the launch, and the launch's threads
__device__ __forceinline__ long long glue_thread() {
  return ((long long)blockIdx.y * gridDim.x + blockIdx.x) * NTG + threadIdx.x;
}
__device__ __forceinline__ long long glue_threads() {
  return (long long)gridDim.x * gridDim.y * NTG;
}

// sum over q < lanes of s_red[q * width + t], in q order, for t < width
__device__ __forceinline__ float lane_sum(const float* s_red, int lanes, int width, int t) {
  float s = 0.f;
  for (int q = 0; q < lanes; ++q) s += s_red[q * width + t];
  return s;
}

// sum of load(i) over i = first, first + step, ... < end, in that order,
// with GLUE_BATCH loads in flight: the chains are L2-latency bound
constexpr int GLUE_BATCH = 8;

template <typename Load>
__device__ __forceinline__ float strided_sum(Load load, long long first, long long end,
                                             long long step) {
  float s = 0.f;
  long long i = first;
  for (; i + (GLUE_BATCH - 1) * step < end; i += GLUE_BATCH * step) {
    float v[GLUE_BATCH];
#pragma unroll
    for (int u = 0; u < GLUE_BATCH; ++u) v[u] = load(i + u * step);
#pragma unroll
    for (int u = 0; u < GLUE_BATCH; ++u) s += v[u];
  }
  for (; i < end; i += step) s += load(i);
  return s;
}

// Block (chunk, segment) sums its chunk's rows of its segment into scratch;
// blocks with blockIdx.y >= segments take no part. The last block of a
// group to finish then sums the group's columns of the chunks' sums, in
// chunk order, into s_tot (planes 0 and 1: [0, w) and [w, 2w), w the
// group's width; the bias's group: [0, nb)) and returns the group; every
// other block returns -1. In a block, `lanes` threads share a column: lane
// q takes the rows q, q + lanes, ... in order, and the lanes are summed in
// lane order, so every sum has one fixed order.
__device__ int glue_reduce(const float* __restrict__ p01, const float* __restrict__ p2, int n_part,
                           int nc, int nb, const GlueLayout& l, float* __restrict__ scratch,
                           unsigned int* arrivals, float* s_tot) {
  __shared__ float s_red[NTG];
  __shared__ bool s_last;
  const int seg = blockIdx.y;
  if (seg >= l.segments) return -1;
  const bool bias = seg == 2 * l.groups;
  const int grp = bias ? l.groups : seg % l.groups, plane = bias ? 2 : seg / l.groups;
  const int col0 = bias ? 0 : grp * l.width, ld = bias ? nb : nc;
  const int w = bias ? nb : min(l.width, nc - col0);
  const float* src = bias ? p2 : p01 + (long long)plane * n_part * nc;
  const int stride = 2 * nc + nb, base = plane * nc + col0;
  const long long r0 = (long long)blockIdx.x * l.rows;
  const long long r1 = min(r0 + l.rows, (long long)n_part);
  for (int c0 = 0; c0 < w; c0 += NTG) {
    const int wc = min(w - c0, NTG), lanes = NTG / wc;
    const int lane = threadIdx.x / wc, col = col0 + c0 + threadIdx.x % wc;
    s_red[threadIdx.x] =
        lane < lanes ? strided_sum([&](long long r) { return src[r * ld + col]; }, r0 + lane,
                                   r1, lanes)
                     : 0.f;
    __syncthreads();
    if (threadIdx.x < wc)
      scratch[(long long)blockIdx.x * stride + base + c0 + threadIdx.x] =
          lane_sum(s_red, lanes, wc, threadIdx.x);
    __syncthreads();
  }
  __threadfence();  // this block's sums reach L2 before it counts itself
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int blocks = (bias ? 1u : 2u) * gridDim.x;
    s_last = atomicAdd(&arrivals[grp], 1u) + 1u == blocks;
    if (s_last) arrivals[grp] = 0u;  // every block of the group has counted
  }
  __syncthreads();
  if (!s_last) return -1;
  __threadfence();
  const int gw = bias ? nb : min(l.width, nc - grp * l.width), nv = bias ? nb : 2 * gw;
  for (int i0 = 0; i0 < nv; i0 += NTG) {
    const int wc = min(nv - i0, NTG), lanes = NTG / wc;
    const int lane = threadIdx.x / wc, i = i0 + threadIdx.x % wc;
    const int col = bias ? 2 * nc + i : i < gw ? grp * l.width + i : nc + grp * l.width + i - gw;
    s_red[threadIdx.x] =
        lane < lanes ? strided_sum([&](long long k) { return __ldcg(scratch + k * stride + col); },
                                   lane, gridDim.x, lanes)
                     : 0.f;
    __syncthreads();
    if (threadIdx.x < wc) s_tot[i] = lane_sum(s_red, lanes, wc, threadIdx.x);
    __syncthreads();
  }
  return grp;
}

// The forward's glue once a layer, after K4 (and once a block before the
// first K4, with the entry's moments): the layer's statistics into the
// block's (mu, m2) at [offset, offset + k), the next layer's fold and kernel.
// REDUCE: sum K4's partials part (2, n_part, k), times 1/n; alone, write
// them to moments (2, k) (a process group averages them between the two
// calls). FINISH: the statistics (from the sums, else from moments) into
// (mu, m2), then the fold and the cast of `next` (c = offset + k, or 0).
struct GlueFwd {
  const float* part;
  float* moments;
  float* mu;
  float* m2;
  float* scratch;
  GlueFold next;
  GlueLayout l;
  int n_part, k, offset, flags;
  float inv_n;
};

template <typename T>
__global__ void __launch_bounds__(NTG) glue_forward_kernel(GlueFwd a) {
  extern __shared__ float s_tot[];
  if (a.flags & GLUE_FINISH) {
    // what waits for no sum: the channels whose statistics are settled
    const int settled = a.flags & GLUE_REDUCE ? a.offset : a.offset + a.k;
    for (long long ch = glue_thread(); ch < settled; ch += glue_threads()) {
      if (ch >= a.offset) {
        a.mu[ch] = a.moments[ch - a.offset];
        a.m2[ch] = a.moments[a.k + ch - a.offset];
      }
      if (ch < a.next.c) fold_channel(a.next, a.mu, a.m2, (int)ch);
    }
    cast_weights<T>(a.next, glue_thread(), glue_threads());
  }
  if (!(a.flags & GLUE_REDUCE) ||
      glue_reduce(a.part, nullptr, a.n_part, a.k, 0, a.l, a.scratch, glue_arrivals[0], s_tot) < 0)
    return;
  for (int f = threadIdx.x; f < a.k; f += NTG) {
    const float mean = __fmul_rn(s_tot[f], a.inv_n), mean2 = __fmul_rn(s_tot[a.k + f], a.inv_n);
    if (!(a.flags & GLUE_FINISH)) {
      a.moments[f] = mean;
      a.moments[a.k + f] = mean2;
      continue;
    }
    const int ch = a.offset + f;
    a.mu[ch] = mean;
    a.m2[ch] = mean2;
    if (ch < a.next.c) fold_channel(a.next, a.mu, a.m2, ch);
  }
}

// The backward's glue once a layer j, after K5 and K6 (and once a block
// before the top layer's K5: HEAD, C1 = gmu/n and C2 = 2*gm2/n over the
// block's ctot channels, and the top layer's fold and kernel). REDUCE: sum
// K5's partials part (2, n_part, c) (sum dpre*x, sum dpre) and part_bias
// (n_part, F) into this rank's dgamma = inv*(dsx - mu*dss), dbeta = dss and
// the bias gradient; alone, write (dsx, dss) to sums (2, c) (a process
// group sums them between the two calls). FINISH: with every rank's (dsx,
// dss) (the sums, else `sums`), layer j's BN-through-statistics gradient
// into C1 and C2 over [0, c), then the fold and the cast of `next` (layer
// j - 1, or c = 0).
struct GlueBwd {
  const float* part;
  const float* part_bias;
  float* sums;
  const float* gmu;
  const float* gm2;
  const float* mu;
  const float* m2;
  float* c1;
  float* c2;
  const float* gamma;
  float* dgamma;
  float* dbeta;
  float* dbias;
  float* scratch;
  GlueFold next;
  GlueLayout l;
  int n_part, c, F, ctot, flags;
  float inv_n;
};

// layer j's update of C1 and C2 at channel ch from every rank's (dsx, dss)
__device__ __forceinline__ void update_c1_c2(const GlueBwd& a, int ch, float dsx, float dss) {
  const float mu = a.mu[ch], inv = bn_inv(mu, a.m2[ch]), gamma = a.gamma[ch];
  const float dgamma = __fmul_rn(inv, __fsub_rn(dsx, __fmul_rn(mu, dss)));
  const float gi = __fmul_rn(gamma, inv);
  a.c2[ch] = __fsub_rn(a.c2[ch], __fmul_rn(__fmul_rn(__fmul_rn(gi, inv), dgamma), a.inv_n));
  const float d = __fsub_rn(__fmul_rn(__fmul_rn(inv, mu), dgamma), dss);
  a.c1[ch] = __fadd_rn(a.c1[ch], __fmul_rn(__fmul_rn(gi, d), a.inv_n));
}

template <typename T>
__global__ void __launch_bounds__(NTG) glue_backward_kernel(GlueBwd a) {
  extern __shared__ float s_tot[];
  if (a.flags & (GLUE_FINISH | GLUE_HEAD)) {
    const long long first = glue_thread(), step = glue_threads();
    for (long long ch = first; ch < a.next.c; ch += step)
      fold_channel(a.next, a.mu, a.m2, (int)ch);
    cast_weights<T>(a.next, first, step);
    if (a.flags & GLUE_HEAD)
      for (long long ch = first; ch < a.ctot; ch += step) {
        a.c1[ch] = __fmul_rn(a.gmu[ch], a.inv_n);
        a.c2[ch] = __fmul_rn(__fmul_rn(2.0f, a.gm2[ch]), a.inv_n);
      }
    else if (!(a.flags & GLUE_REDUCE))
      for (long long ch = first; ch < a.c; ch += step)
        update_c1_c2(a, (int)ch, a.sums[ch], a.sums[a.c + ch]);
  }
  if (!(a.flags & GLUE_REDUCE)) return;
  const int grp = glue_reduce(a.part, a.part_bias, a.n_part, a.c, a.F, a.l, a.scratch,
                              glue_arrivals[1], s_tot);
  if (grp < 0) return;
  if (grp == a.l.groups) {
    for (int f = threadIdx.x; f < a.F; f += NTG) a.dbias[f] = s_tot[f];
    return;
  }
  const int first = grp * a.l.width, w = min(a.l.width, a.c - first);
  for (int i = threadIdx.x; i < w; i += NTG) {
    const int ch = first + i;
    const float dsx = s_tot[i], dss = s_tot[w + i];
    a.dgamma[ch] = __fmul_rn(bn_inv(a.mu[ch], a.m2[ch]), __fsub_rn(dsx, __fmul_rn(a.mu[ch], dss)));
    a.dbeta[ch] = dss;
    if (a.flags & GLUE_FINISH) {
      update_c1_c2(a, ch, dsx, dss);
    } else {
      a.sums[ch] = dsx;
      a.sums[a.c + ch] = dss;
    }
  }
}

// Once a block: every layer j's running statistics, r = 0.9*r + 0.1*stat
// over its prefix [0, c0 + j*F), the variance the biased m2 - mu^2, from
// the block's (mu, m2); keep and take are PyTorch's f32 roundings of the
// momentum and of 1 - momentum. grid.y = the layers.
constexpr int STATS_LAYERS = 32;  // layers a launch

struct RunningStats {
  float* mean[STATS_LAYERS];
  float* var[STATS_LAYERS];
};

__global__ void __launch_bounds__(NTG) glue_running_stats_kernel(
    RunningStats r, const float* __restrict__ mu, const float* __restrict__ m2, int c0, int F,
    float keep, float take) {
  const int j = blockIdx.y, c = c0 + j * F;
  float* mean = r.mean[j];
  float* var = r.var[j];
  for (int ch = blockIdx.x * NTG + threadIdx.x; ch < c; ch += gridDim.x * NTG) {
    const float m = mu[ch], v = __fsub_rn(m2[ch], __fmul_rn(m, m));
    mean[ch] = __fadd_rn(__fmul_rn(keep, mean[ch]), __fmul_rn(take, m));
    var[ch] = __fadd_rn(__fmul_rn(keep, var[ch]), __fmul_rn(take, v));
  }
}

int tiles(int n, int t) { return (n + t - 1) / t; }

bool bad_dims(int B, int H, int W, int C, int F, int ld) {
  return B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || F > MAX_GROWTH ||
         C + F > ld || B > 65535;
}

// f32 K4 (FFMA); bf16 goes to launch_fwd_mma
cudaError_t launch_fwd_f32(void* buf, const float* scale, const float* shift,
                           const void* w, const float* bias, float* part, int B,
                           int H, int W, int C, int F, int ld, cudaStream_t s) {
  using T = float;
  const dim3 block(TW, TY), grid(tiles(W, TW), tiles(H, TH), B);
  T* b = static_cast<T*>(buf);
  const T* wt = static_cast<const T*>(w);
  switch ((F + 3) / 4) {
    case 1: fwd_kernel<T, 4><<<grid, block, 0, s>>>(b, scale, shift, wt, bias, part, H, W, C, F, ld); break;
    case 2: fwd_kernel<T, 8><<<grid, block, 0, s>>>(b, scale, shift, wt, bias, part, H, W, C, F, ld); break;
    case 3: fwd_kernel<T, 12><<<grid, block, 0, s>>>(b, scale, shift, wt, bias, part, H, W, C, F, ld); break;
    default: fwd_kernel<T, 16><<<grid, block, 0, s>>>(b, scale, shift, wt, bias, part, H, W, C, F, ld); break;
  }
  return cudaGetLastError();
}

// the 16-byte path of the bf16 kernels: rows of buf (and grad) 16-byte
// aligned, even C and F, the weights' channel pairs 4-byte aligned
bool vec_path(const void* buf, const void* grad, const void* w, int C, int F,
              int ld) {
  return ld % 8 == 0 && C % 2 == 0 && F % 2 == 0 &&
         reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 4 == 0;
}

cudaError_t launch_fwd_mma(void* buf, const float* scale, const float* shift,
                           const void* w, const float* bias, float* part,
                           float* ypart, int B, int H, int W, int C, int F,
                           int ld, int n_split, int tile_w, cudaStream_t s) {
  auto* b = static_cast<__nv_bfloat16*>(buf);
  return launch_conv3x3_fwd_mma<true, false>(
      b, ld, scale, shift, static_cast<const __nv_bfloat16*>(w), bias, b + C, ld,
      part, ypart, B, H, W, C, F, n_split, tile_w, vec_path(buf, buf, w, C, F, ld) ? 8 : 1,
      s);
}

// f32 K5 (FFMA); bf16 goes to launch_dinput_mma
cudaError_t launch_dinput_f32(void* grad, const void* buf, const float* scale,
                              const float* shift, const void* w, const float* c1,
                              const float* c2, float* part, float* part_bias,
                              int B, int H, int W, int C, int F, int ld,
                              int n_split, cudaStream_t s) {
  using T = float;
  const int cpb = tiles(tiles(C, CC), n_split);
  const dim3 block(TW, TY), grid(tiles(W, TW), tiles(H, TH), B * n_split);
  T* g = static_cast<T*>(grad);
  const T* b = static_cast<const T*>(buf);
  const T* wt = static_cast<const T*>(w);
  switch ((F + 3) / 4) {
    case 1: dinput_kernel<T, 4><<<grid, block, 0, s>>>(g, b, scale, shift, wt, c1, c2, part, part_bias, B, H, W, C, F, ld, n_split, cpb); break;
    case 2: dinput_kernel<T, 8><<<grid, block, 0, s>>>(g, b, scale, shift, wt, c1, c2, part, part_bias, B, H, W, C, F, ld, n_split, cpb); break;
    case 3: dinput_kernel<T, 12><<<grid, block, 0, s>>>(g, b, scale, shift, wt, c1, c2, part, part_bias, B, H, W, C, F, ld, n_split, cpb); break;
    default: dinput_kernel<T, 16><<<grid, block, 0, s>>>(g, b, scale, shift, wt, c1, c2, part, part_bias, B, H, W, C, F, ld, n_split, cpb); break;
  }
  return cudaGetLastError();
}

// kernel's dynamic shared-memory opt-in to `bytes`, once per device (bit d
// of `ready`, one `ready` per kernel instantiation)
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int TWL, bool VEC>
cudaError_t launch_mma(dim3 grid, cudaStream_t s, __nv_bfloat16* grad,
                       const __nv_bfloat16* buf, const float* scale,
                       const float* shift, const __nv_bfloat16* w,
                       const float* c1, const float* c2, float* part,
                       float* part_bias, int H, int W, int C, int F, int ld) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = opt_in_smem(dinput_mma_kernel<TWL, VEC>, SMEM5, ready);
  if (err != cudaSuccess) return err;
  dinput_mma_kernel<TWL, VEC><<<grid, NT5, SMEM5, s>>>(
      grad, buf, scale, shift, w, c1, c2, part, part_bias, H, W, C, F, ld);
  return cudaGetLastError();
}

cudaError_t launch_dinput_mma(void* grad, const void* buf, const float* scale,
                              const float* shift, const void* w, const float* c1,
                              const float* c2, float* part, float* part_bias,
                              int B, int H, int W, int C, int F, int ld,
                              int n_split, int tile_w, cudaStream_t s) {
  const dim3 grid(n_split, tiles(H, M5 / tile_w) * tiles(W, tile_w), B);
  auto* g = static_cast<__nv_bfloat16*>(grad);
  auto* b = static_cast<const __nv_bfloat16*>(buf);
  auto* wt = static_cast<const __nv_bfloat16*>(w);
  switch (tile_w + vec_path(buf, grad, w, C, F, ld)) {
    case 33: return launch_mma<5, true>(grid, s, g, b, scale, shift, wt, c1, c2, part, part_bias, H, W, C, F, ld);
    case 32: return launch_mma<5, false>(grid, s, g, b, scale, shift, wt, c1, c2, part, part_bias, H, W, C, F, ld);
    case 17: return launch_mma<4, true>(grid, s, g, b, scale, shift, wt, c1, c2, part, part_bias, H, W, C, F, ld);
    case 16: return launch_mma<4, false>(grid, s, g, b, scale, shift, wt, c1, c2, part, part_bias, H, W, C, F, ld);
    case 9: return launch_mma<3, true>(grid, s, g, b, scale, shift, wt, c1, c2, part, part_bias, H, W, C, F, ld);
    default: return launch_mma<3, false>(grid, s, g, b, scale, shift, wt, c1, c2, part, part_bias, H, W, C, F, ld);
  }
}

// f32 K6 (FFMA); bf16 goes to launch_dweight_mma
cudaError_t launch_dweight_f32(const void* grad, const void* buf,
                               const float* scale, const float* shift,
                               const float* c1, const float* c2, float* part,
                               int B, int H, int W, int C, int F, int ld,
                               int n_split, cudaStream_t s) {
  using T = float;
  const dim3 grid(tiles(C, CC), n_split);
  const T* g = static_cast<const T*>(grad);
  const T* b = static_cast<const T*>(buf);
  switch ((F + 3) / 4) {
    case 1: dweight_kernel<T, 4><<<grid, NT6, 0, s>>>(g, b, scale, shift, c1, c2, part, B, H, W, C, F, ld); break;
    case 2: dweight_kernel<T, 8><<<grid, NT6, 0, s>>>(g, b, scale, shift, c1, c2, part, B, H, W, C, F, ld); break;
    case 3: dweight_kernel<T, 12><<<grid, NT6, 0, s>>>(g, b, scale, shift, c1, c2, part, B, H, W, C, F, ld); break;
    default: dweight_kernel<T, 16><<<grid, NT6, 0, s>>>(g, b, scale, shift, c1, c2, part, B, H, W, C, F, ld); break;
  }
  return cudaGetLastError();
}

// bf16 K6's 16/8-byte path (VW = 8): see dweight_mma_kernel
bool dweight_vec_ok(const void* buf, const void* grad, int C, int F, int ld) {
  return ld % 8 == 0 && C % 4 == 0 && F % 4 == 0 &&
         reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(grad) % 16 == 0;
}

template <int TWL, int VW>
cudaError_t launch_dweight_mma_t(dim3 grid, cudaStream_t s, const __nv_bfloat16* grad,
                                 const __nv_bfloat16* buf, const float* scale,
                                 const float* shift, const float* c1, const float* c2,
                                 float* part, int B, int H, int W, int C, int F, int ld) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = opt_in_smem(dweight_mma_kernel<TWL, VW>, DW_SMEM, ready);
  if (err != cudaSuccess) return err;
  dweight_mma_kernel<TWL, VW><<<grid, DW_THREADS, DW_SMEM, s>>>(
      grad, buf, scale, shift, c1, c2, part, B, H, W, C, F, ld);
  return cudaGetLastError();
}

cudaError_t launch_dweight_mma(const void* grad, const void* buf,
                               const float* scale, const float* shift,
                               const float* c1, const float* c2, float* part,
                               int B, int H, int W, int C, int F, int ld,
                               int n_split, int tile_w, int vw, cudaStream_t s) {
  const dim3 grid(tiles(C, CC), n_split);
  auto* g = static_cast<const __nv_bfloat16*>(grad);
  auto* b = static_cast<const __nv_bfloat16*>(buf);
#define DWEIGHT_LAUNCH(TWL, VW) \
  launch_dweight_mma_t<TWL, VW>(grid, s, g, b, scale, shift, c1, c2, part, B, H, W, C, F, ld)
  switch (tile_w * 16 + vw) {
    case 32 * 16 + 8: return DWEIGHT_LAUNCH(5, 8);
    case 32 * 16 + 1: return DWEIGHT_LAUNCH(5, 1);
    case 16 * 16 + 8: return DWEIGHT_LAUNCH(4, 8);
    case 16 * 16 + 1: return DWEIGHT_LAUNCH(4, 1);
    case 8 * 16 + 8: return DWEIGHT_LAUNCH(3, 8);
    case 8 * 16 + 1: return DWEIGHT_LAUNCH(3, 1);
    default: return cudaErrorInvalidValue;
  }
#undef DWEIGHT_LAUNCH
}

// A boundary launch, decided here alone: vw = 16 / sizeof(T) channels a
// lane (one 16-byte vector) where C0 and ld are multiples of it and every
// base is 16-byte aligned, else 1; `lanes` channel vectors a pixel row (at
// most NTB), NTB / lanes rows a block, grid.y = the groups of lanes a row
// needs, grid.x = the blocks that stride over the P pixels, at most
// BOUNDARY_BLOCKS in all
constexpr int BOUNDARY_BLOCKS = 396;  // one wave at 3 blocks an SM on 132 SMs

struct BoundaryLayout {
  int vw, lanes, rows, groups, blocks;
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

BoundaryLayout boundary_layout(int dtype, long long P, int C0, int ld, const void* a,
                               const void* b, const void* c) {
  const int full = dtype == 1 ? 8 : 4;
  const int vw = C0 % full == 0 && ld % full == 0 && aligned16(a) && aligned16(b) &&
                         aligned16(c) ? full : 1;
  const int nv = C0 / vw;
  const int lanes = nv < NTB ? nv : NTB;
  const int rows = NTB / lanes, groups = tiles(nv, lanes);
  const long long want = (P + rows - 1) / rows, cap = BOUNDARY_BLOCKS / groups;
  const long long blocks = want < cap ? want : cap;
  return {vw, lanes, rows, groups, blocks > 1 ? (int)blocks : 1};
}

bool boundary_ok(int dtype, int B, int H, int W, int C0, int ld) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && W >= 1 && C0 >= 1 && C0 <= ld;
}

template <typename T, int VW>
cudaError_t launch_entry(const BoundaryLayout& l, const void* x, void* buf, double* part,
                         float* out, long long P, int C0, int ld, cudaStream_t s) {
  boundary_entry_kernel<T, VW><<<dim3(l.blocks, l.groups), NTB, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(buf), part, P, C0, ld, l.lanes, l.rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  boundary_entry_finish_kernel<<<2 * C0, NTB, 0, s>>>(part, out, l.blocks, (double)P);
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t launch_exit(const BoundaryLayout& l, const void* grad, const void* buf,
                        const float* c1, const float* c2, void* dx, long long P, int C0,
                        int ld, cudaStream_t s) {
  boundary_exit_kernel<T, VW><<<dim3(l.blocks, l.groups), NTB, 0, s>>>(
      static_cast<const T*>(grad), static_cast<const T*>(buf), c1, c2, static_cast<T*>(dx),
      P, C0, ld, l.lanes, l.rows);
  return cudaGetLastError();
}

// A glue reduction's layout for n_part rows of 2*nc + nb columns (nc at
// most GLUE_CHANNELS: the C entries check it): groups of at most
// GLUE_WIDTH channels, as even as they come, rows split into chunks of at
// least GLUE_ROWS, about GLUE_BLOCKS blocks in all
GlueLayout glue_layout(int n_part, int nc, int nb) {
  const int width = tiles(nc, tiles(nc, GLUE_WIDTH));
  const int groups = tiles(nc, width);
  const int segments = 2 * groups + (nb > 0 ? 1 : 0);
  const int cap = GLUE_BLOCKS / segments > 1 ? GLUE_BLOCKS / segments : 1;
  int chunks = tiles(n_part, GLUE_ROWS);
  if (chunks > cap) chunks = cap;
  const int rows = tiles(n_part, chunks);
  return {groups, width, segments, tiles(n_part, rows), rows};
}

// The grid of a glue launch: the reduction's blocks (chunks x segments)
// and enough more rows of blocks for the work that waits for no sum
// (`work` elements, about 4 a thread, at most GLUE_BLOCKS blocks); without
// a reduction, those blocks alone
dim3 glue_grid(bool reduce, const GlueLayout& l, long long work) {
  long long want = (work + 4 * NTG - 1) / (4 * NTG);
  if (want > GLUE_BLOCKS) want = GLUE_BLOCKS;
  if (want < 1) want = 1;
  if (!reduce) return dim3((unsigned)want, 1);
  const long long rows = (want + l.chunks - 1) / l.chunks;
  return dim3(l.chunks, rows > l.segments ? (unsigned)rows : l.segments);
}

bool glue_fold_ok(const GlueFold& f) {
  return f.c == 0 || (f.c > 0 && f.F >= 1 && f.F <= MAX_GROWTH && 9LL * f.c * f.F <= INT_MAX &&
                      f.gamma && f.beta && f.scale && f.shift && f.w_in && f.w_out);
}

long long fold_work(const GlueFold& f) { return 9LL * f.c * f.F; }

template <typename T>
cudaError_t launch_glue_fwd(const GlueFwd& a, cudaStream_t s) {
  const long long work = fold_work(a.next) > a.offset + a.k ? fold_work(a.next) : a.offset + a.k;
  const dim3 grid = glue_grid(a.flags & GLUE_REDUCE, a.l, work);
  glue_forward_kernel<T><<<grid, NTG, 2 * a.l.width * sizeof(float), s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_glue_bwd(const GlueBwd& a, cudaStream_t s) {
  long long work = fold_work(a.next);
  if (a.ctot > work) work = a.ctot;
  const int smem = (2 * a.l.width > a.F ? 2 * a.l.width : a.F) * (int)sizeof(float);
  const dim3 grid = glue_grid(a.flags & GLUE_REDUCE, a.l, work);
  glue_backward_kernel<T><<<grid, NTG, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int block_engine_max_growth() { return MAX_GROWTH; }

// All three: dtype 0 = float32, 1 = bfloat16 for buf, grad and w; scale,
// shift, bias, c1, c2 and every partial are float32. buf and grad are
// contiguous (B, H, W, ld); the layer reads channels [0, C) and owns
// [C, C+F). n_part must be the kernel's count of spatial tiles, as below.
// Each returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments it does not take.

// K4. part: (2, n_part, F), the per-tile (sum y, sum y^2); ypart: with
// n_split > 1, (n_split, n_part, 256, 16) float32 scratch (else unused).
// float32: tile_w = 32 (16x32 tiles), n_split = 1. bfloat16: tile_w = 32,
// 16 or 8 (tiles of 256 pixels, 256/tile_w rows), n_split in
// 1 .. ceil(C/16): how many blocks share one tile's 16-channel chunks.
int block_engine_fwd(int dtype, void* buf, const void* scale,
                     const void* shift, const void* w, const void* bias,
                     void* part, void* ypart, int B, int H, int W, int C,
                     int F, int ld, int n_part, int n_split, int tile_w,
                     void* stream) {
  if (bad_dims(B, H, W, C, F, ld)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && (tile_w != TW || n_split != 1 ||
                     n_part != B * tiles(H, TH) * tiles(W, TW)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (!mma_tile_width(tile_w) || n_split < 1 ||
                     n_split > tiles(C, CC) || n_split > 65535 ||
                     tiles(H, MMA_PIXELS / tile_w) * tiles(W, tile_w) > 65535 ||
                     n_part != B * tiles(H, MMA_PIXELS / tile_w) * tiles(W, tile_w) ||
                     (long long)H * W * ld > INT_MAX))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* bi = static_cast<const float*>(bias);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_f32(buf, sc, sh, w, bi, p, B, H, W, C, F, ld, s);
  if (dtype == 1)
    return (int)launch_fwd_mma(buf, sc, sh, w, bi, p, static_cast<float*>(ypart),
                               B, H, W, C, F, ld, n_split, tile_w, s);
  return (int)cudaErrorInvalidValue;
}

// K5. part: (2, n_part, C), the per-tile (sum dpre*x, sum dpre); part_bias:
// (n_part, F), the per-tile sum of gy_eff. n_split: how many blocks share
// one tile's channels. float32: tile_w = 32 (16x32 tiles), n_split in
// 1 .. ceil(C/16). bfloat16: tile_w = 32, 16 or 8 (tiles of 256 pixels,
// 256/tile_w rows), n_split = ceil(C/32), one block per 32 channels.
int block_engine_dinput(int dtype, void* grad, const void* buf,
                        const void* scale, const void* shift, const void* w,
                        const void* c1, const void* c2, void* part,
                        void* part_bias, int B, int H, int W, int C, int F,
                        int ld, int n_part, int n_split, int tile_w,
                        void* stream) {
  if (bad_dims(B, H, W, C, F, ld)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && (tile_w != TW || n_part != B * tiles(H, TH) * tiles(W, TW) ||
                     n_split < 1 || n_split > tiles(C, CC) || B * n_split > 65535))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (!mma_tile_width(tile_w) || n_split != tiles(C, N5) ||
                     tiles(H, M5 / tile_w) * tiles(W, tile_w) > 65535 ||
                     n_part != B * tiles(H, M5 / tile_w) * tiles(W, tile_w)))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* a = static_cast<const float*>(c1);
  const float* b = static_cast<const float*>(c2);
  float* p = static_cast<float*>(part);
  float* pb = static_cast<float*>(part_bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dinput_f32(grad, buf, sc, sh, w, a, b, p, pb, B, H, W,
                                  C, F, ld, n_split, s);
  if (dtype == 1)
    return (int)launch_dinput_mma(grad, buf, sc, sh, w, a, b, p, pb, B, H, W,
                                  C, F, ld, n_split, tile_w, s);
  return (int)cudaErrorInvalidValue;
}

// K6. part: (n_split, 9, C, F) scratch; dw: (3, 3, C, F), the sum of the
// partials in split order. n_split: how many blocks share one channel
// chunk's tiles (1 .. the tile count). float32: tile_w = 32 (8x32 tiles),
// vw = 1. bfloat16: tile_w = 32, 16 or 8 (tiles of 256 pixels, 256/tile_w
// rows); vw = 8 (the prefix in 16-byte vectors, g and y in 8-byte ones:
// ld % 8 == 0, C and F multiples of 4, buf and grad 16-byte aligned) or 1
// (scalars).
int block_engine_dweight(int dtype, const void* grad, const void* buf,
                         const void* scale, const void* shift, const void* c1,
                         const void* c2, void* part, void* dw, int B, int H,
                         int W, int C, int F, int ld, int n_split, int tile_w,
                         int vw, void* stream) {
  if (bad_dims(B, H, W, C, F, ld) || n_split < 1 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && (tile_w != TW6 || vw != 1 ||
                     n_split > (long long)B * tiles(H, TH6) * tiles(W, TW6)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (!mma_tile_width(tile_w) ||
                     n_split > (long long)B * tiles(H, MMA_PIXELS / tile_w) * tiles(W, tile_w) ||
                     !(vw == 1 || (vw == 8 && dweight_vec_ok(buf, grad, C, F, ld))) ||
                     (long long)H * W * ld > INT_MAX))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* a = static_cast<const float*>(c1);
  const float* b = static_cast<const float*>(c2);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dweight_f32(grad, buf, sc, sh, a, b, p, B, H, W, C, F, ld, n_split, s);
  else if (dtype == 1)
    err = launch_dweight_mma(grad, buf, sc, sh, a, b, p, B, H, W, C, F, ld, n_split,
                             tile_w, vw, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * C * F;
  sum_partials_kernel<<<tiles(n, 256), 256, 0, s>>>(p, static_cast<float*>(dw), n_split, n);
  return (int)cudaGetLastError();
}

// The boundary, both: dtype as above for x, buf, grad and dx; buf and grad
// contiguous (B, H, W, ld), the block input the prefix [0, C0); x and dx
// contiguous (B, H, W, C0). The C side picks the vector width and the grid
// from these arguments (`boundary_layout`).

// The layout the entry (a = x, b = c = buf) or the exit (a = grad, b =
// buf, c = dx) takes for these arguments, into out[5]: vw, lanes, rows,
// grid.y, grid.x. The entry's scratch is (2, C0, grid.x) float64. Returns
// cudaErrorInvalidValue where the kernels refuse the arguments.
int block_engine_boundary_layout(int dtype, const void* a, const void* b, const void* c,
                                 int B, int H, int W, int C0, int ld, int* out) {
  if (!boundary_ok(dtype, B, H, W, C0, ld)) return (int)cudaErrorInvalidValue;
  const BoundaryLayout l = boundary_layout(dtype, (long long)B * H * W, C0, ld, a, b, c);
  out[0] = l.vw;
  out[1] = l.lanes;
  out[2] = l.rows;
  out[3] = l.groups;
  out[4] = l.blocks;
  return 0;
}

// Entry: x into buf[..., :C0]; out (2, C0) float32, x's per-channel mean and
// mean of squares; part: float64 scratch of part_elems, at least 2 * C0 *
// grid.x.
int block_engine_entry(int dtype, const void* x, void* buf, void* part, void* out, int B,
                       int H, int W, int C0, int ld, int part_elems, void* stream) {
  if (!boundary_ok(dtype, B, H, W, C0, ld)) return (int)cudaErrorInvalidValue;
  const long long P = (long long)B * H * W;
  const BoundaryLayout l = boundary_layout(dtype, P, C0, ld, x, buf, buf);
  if ((long long)part_elems < 2LL * C0 * l.blocks) return (int)cudaErrorInvalidValue;
  double* p = static_cast<double*>(part);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(l.vw == 8 ? launch_entry<__nv_bfloat16, 8>(l, x, buf, p, o, P, C0, ld, s)
                           : launch_entry<__nv_bfloat16, 1>(l, x, buf, p, o, P, C0, ld, s));
  return (int)(l.vw == 4 ? launch_entry<float, 4>(l, x, buf, p, o, P, C0, ld, s)
                         : launch_entry<float, 1>(l, x, buf, p, o, P, C0, ld, s));
}

// Exit: dx = (g + c1) + c2*x from grad[..., :C0] and buf[..., :C0], each
// step rounded to f32, then to dx's type; c1, c2: float32, C0 or more.
int block_engine_exit(int dtype, const void* grad, const void* buf, const void* c1,
                      const void* c2, void* dx, int B, int H, int W, int C0, int ld,
                      void* stream) {
  if (!boundary_ok(dtype, B, H, W, C0, ld)) return (int)cudaErrorInvalidValue;
  const long long P = (long long)B * H * W;
  const BoundaryLayout l = boundary_layout(dtype, P, C0, ld, grad, buf, dx);
  const float* a = static_cast<const float*>(c1);
  const float* b = static_cast<const float*>(c2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(l.vw == 8 ? launch_exit<__nv_bfloat16, 8>(l, grad, buf, a, b, dx, P, C0, ld, s)
                           : launch_exit<__nv_bfloat16, 1>(l, grad, buf, a, b, dx, P, C0, ld, s));
  return (int)(l.vw == 4 ? launch_exit<float, 4>(l, grad, buf, a, b, dx, P, C0, ld, s)
                         : launch_exit<float, 1>(l, grad, buf, a, b, dx, P, C0, ld, s));
}

// The glue: dtype as above for the cast weights w_out; every other tensor
// float32 and contiguous. flags: GLUE_REDUCE (1), GLUE_FINISH (2) or both.
// A reduction takes at most GLUE_CHANNELS channels. The next layer's fold: gamma, beta,
// scale, shift (c_next,), its kernel w_in (3, 3, c_next, F) float32 at
// element strides s0..s3, w_out (3, 3, c_next, F) contiguous; c_next = 0:
// none. inv_n: the f32 1/n. scratch: float32, at least the layout's
// elements, with a reduction.

// The layout of a reduction of n_part rows of 2*nc + nb columns, into
// out[6]: groups, width, segments, chunks, rows, and the scratch's elements.
int block_engine_glue_layout(int n_part, int nc, int nb, int* out) {
  if (n_part < 1 || nc < 1 || nc > GLUE_CHANNELS || nb < 0 || nb > MAX_GROWTH)
    return (int)cudaErrorInvalidValue;
  const GlueLayout l = glue_layout(n_part, nc, nb);
  const long long elems = (long long)l.chunks * (2LL * nc + nb);
  if (elems > INT_MAX) return (int)cudaErrorInvalidValue;
  out[0] = l.groups;
  out[1] = l.width;
  out[2] = l.segments;
  out[3] = l.chunks;
  out[4] = l.rows;
  out[5] = (int)elems;
  return 0;
}

// Forward, the layer's channels [offset, offset + k): part (2, n_part, k),
// moments (2, k), mu and m2 the block's (at least offset + k). c_next is 0
// or offset + k, and only with GLUE_FINISH.
int block_engine_glue_fwd(int dtype, const void* part, void* moments, void* mu, void* m2,
                          void* scratch, const void* gamma, const void* beta, const void* w_in,
                          void* scale, void* shift, void* w_out, int n_part, int k, int offset,
                          int c_next, int F, int s0, int s1, int s2, int s3, float inv_n, int flags,
                          int scratch_elems, void* stream) {
  const bool reduce = flags & GLUE_REDUCE;
  if ((dtype != 0 && dtype != 1) || flags < 1 || flags > 3 || k < 1 || offset < 0 ||
      (reduce && (n_part < 1 || k > GLUE_CHANNELS)) ||
      (c_next != 0 && (c_next != offset + k || !(flags & GLUE_FINISH))))
    return (int)cudaErrorInvalidValue;
  GlueFwd a{static_cast<const float*>(part), static_cast<float*>(moments), static_cast<float*>(mu),
            static_cast<float*>(m2), static_cast<float*>(scratch),
            {static_cast<const float*>(gamma), static_cast<const float*>(beta),
             static_cast<float*>(scale), static_cast<float*>(shift),
             static_cast<const float*>(w_in), w_out, c_next, F, s0, s1, s2, s3},
            {}, n_part, k, offset, flags, inv_n};
  if (!glue_fold_ok(a.next)) return (int)cudaErrorInvalidValue;
  if (reduce) {
    a.l = glue_layout(n_part, k, 0);
    if ((long long)scratch_elems < (long long)a.l.chunks * 2 * k) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_glue_fwd<__nv_bfloat16>(a, s) : launch_glue_fwd<float>(a, s));
}

// Backward, layer j's prefix [0, c) with growth F: part (2, n_part, c),
// part_bias (n_part, F), sums (2, c), gamma (c,) layer j's, dgamma and
// dbeta (c,), dbias (F,); c1 and c2 the block's (at least c). c_next is 0
// or c - F, and only with GLUE_FINISH.
int block_engine_glue_bwd(int dtype, const void* part, const void* part_bias, void* sums,
                          const void* mu, const void* m2, void* c1, void* c2, const void* gamma,
                          void* dgamma, void* dbeta, void* dbias, void* scratch,
                          const void* gamma_next, const void* beta_next, const void* w_in,
                          void* scale, void* shift, void* w_out, int n_part, int c, int F,
                          int c_next, int s0, int s1, int s2, int s3, float inv_n, int flags,
                          int scratch_elems, void* stream) {
  const bool reduce = flags & GLUE_REDUCE;
  if ((dtype != 0 && dtype != 1) || flags < 1 || flags > 3 || c < 1 || F < 1 ||
      F > MAX_GROWTH || (reduce && (n_part < 1 || c > GLUE_CHANNELS)) ||
      (c_next != 0 && (c_next != c - F || !(flags & GLUE_FINISH))))
    return (int)cudaErrorInvalidValue;
  GlueBwd a{static_cast<const float*>(part), static_cast<const float*>(part_bias),
            static_cast<float*>(sums), nullptr, nullptr, static_cast<const float*>(mu),
            static_cast<const float*>(m2), static_cast<float*>(c1), static_cast<float*>(c2),
            static_cast<const float*>(gamma), static_cast<float*>(dgamma),
            static_cast<float*>(dbeta), static_cast<float*>(dbias), static_cast<float*>(scratch),
            {static_cast<const float*>(gamma_next), static_cast<const float*>(beta_next),
             static_cast<float*>(scale), static_cast<float*>(shift),
             static_cast<const float*>(w_in), w_out, c_next, F, s0, s1, s2, s3},
            {}, n_part, c, F, c, flags, inv_n};
  if (!glue_fold_ok(a.next)) return (int)cudaErrorInvalidValue;
  if (reduce) {
    a.l = glue_layout(n_part, c, F);
    if ((long long)scratch_elems < (long long)a.l.chunks * (2LL * c + F))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_glue_bwd<__nv_bfloat16>(a, s) : launch_glue_bwd<float>(a, s));
}

// The backward's start, before a block's top layer: c1, c2 (ctot,) =
// gmu/n, 2*gm2/n, and the top layer's fold (c_next, at most ctot; F its
// growth), one launch of the backward's glue kernel
int block_engine_glue_bwd_start(int dtype, const void* gmu, const void* gm2, const void* mu,
                                const void* m2, void* c1, void* c2, const void* gamma,
                                const void* beta, const void* w_in, void* scale, void* shift,
                                void* w_out, int ctot, int c_next, int F, int s0, int s1, int s2,
                                int s3, float inv_n, void* stream) {
  if ((dtype != 0 && dtype != 1) || ctot < 1 || c_next < 1 || c_next > ctot)
    return (int)cudaErrorInvalidValue;
  GlueBwd a{};
  a.gmu = static_cast<const float*>(gmu);
  a.gm2 = static_cast<const float*>(gm2);
  a.mu = static_cast<const float*>(mu);
  a.m2 = static_cast<const float*>(m2);
  a.c1 = static_cast<float*>(c1);
  a.c2 = static_cast<float*>(c2);
  a.next = {static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<float*>(scale), static_cast<float*>(shift), static_cast<const float*>(w_in),
            w_out, c_next, F, s0, s1, s2, s3};
  a.F = F;
  a.ctot = ctot;
  a.flags = GLUE_HEAD;
  a.inv_n = inv_n;
  if (!glue_fold_ok(a.next)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_glue_bwd<__nv_bfloat16>(a, s) : launch_glue_bwd<float>(a, s));
}

// Running statistics of a block's n_layers (at most STATS_LAYERS) layers:
// means[j], vars[j] (c0 + j*F,) float32, from the block's mu and m2.
int block_engine_running_stats(void* const* means, void* const* vars, const void* mu,
                               const void* m2, int c0, int F, int n_layers, float keep,
                               float take, void* stream) {
  if (c0 < 1 || F < 1 || n_layers < 1 || n_layers > STATS_LAYERS) return (int)cudaErrorInvalidValue;
  RunningStats r{};
  for (int j = 0; j < n_layers; ++j) {
    r.mean[j] = static_cast<float*>(means[j]);
    r.var[j] = static_cast<float*>(vars[j]);
  }
  const dim3 grid(tiles(c0 + (n_layers - 1) * F, NTG), n_layers);
  glue_running_stats_kernel<<<grid, NTG, 0, static_cast<cudaStream_t>(stream)>>>(
      r, static_cast<const float*>(mu), static_cast<const float*>(m2), c0, F, keep, take);
  return (int)cudaGetLastError();
}

}  // extern "C"
