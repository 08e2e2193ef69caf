// The bf16 fused dense-layer forward as an implicit GEMM on Hopper's tensor
// cores (sm_90a), shared by K1 (csrc/dense_conv.cu, the serving path's
// layer) and K4 (csrc/block_engine.cu, the block engine's layer forward):
//
//   y[b,h,w,f] = bias[f] + sum_{ky,kx,c} a[b,h+ky-1,w+kx-1,c] * W[ky,kx,c,f]
//   a = bf16(max(x*scale + shift, 0)), zero outside the image
//
// The two callers differ only in where x and y live: K1 reads x (B, H, W, C)
// at row stride C and writes its own y (B, H, W, F) at row stride F; K4
// reads the prefix [0, C) of a block buffer (B, H, W, ld) and writes y into
// the same buffer at channel offset C, both at row stride ld. K4 also wants
// the per-tile (sum y, sum y^2) of the stored y (STATS); K1 does not, and
// its bias may be null.
//
// Design: M = 256 pixels of one image (a 8x32, 16x16 or 32x8 tile), N = 16
// (F zero-padded: two n8 tiles cover every growth up to 16), K = 9 taps x
// 16-channel chunks, 8 warps of 32 pixels, mma.sync m16n8k16 with f32
// accumulators. The A operand is the chunk's activated halo, computed in
// registers from the raw x as the plain version rounds it (the product and
// the sum rounded separately) and stored [pos][16] at a 48-byte pitch, so
// that ldmatrix rows hit distinct banks; B is the chunk's weights
// [tap][f][c]. The chunk loop runs on two shared-memory stages: after a
// warp's 36 MMAs on chunk k it stages chunk k+1 into the other stage (every
// load issued before the first store), so one barrier a chunk; three blocks
// an SM hide each other's load latency. The epilogue works from the
// fragments: the bias, y rounded to bf16 and stored as channel pairs, and
// with STATS the sums of the stored y over lanes, then warps, in a fixed
// order. Where an image has fewer tiles than the card has SMs, the chunks
// split evenly across blocks (gridDim.x of them, the caller's choice): each
// writes its f32 partial y, and conv3x3_fwd_finish_kernel sums them in split
// order. No atomics: bitwise repeatable.
//
// The halo moves as VW channels a lane: 16-byte vectors (VW = 8), 8-byte
// vectors (VW = 4) or scalars (VW = 1); with VW > 1 the weights and y move
// as channel pairs. The caller guarantees, for VW > 1: ldx % VW == 0 and x
// aligned to 2*VW bytes, so every vector that starts below C ends inside
// the row (K4: inside ld; K1, ldx = C: at or before C, never in the next
// pixel or past the tensor's end); F and ldy even and y, w 4-byte aligned.
// Channels >= C and the image border are zeroed by a select: for K4 they
// are the layer's own channels, being written by neighbouring blocks; for
// K1 the next pixel's.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CC = 16;            // channels per chunk: one k16 step per tap
constexpr int MMA_PIXELS = 256;   // M: pixels per tile
constexpr int MMA_N = 16;         // N: output channels, F zero-padded
constexpr int MMA_THREADS = 256;  // 8 warps x 32 pixels
constexpr int MMA_HALO = 340;     // max (256/tw + 2) * (tw + 2), tw 8..32
constexpr int GP = 24;            // halo and weight row pitch (bf16)

// relu(x*scale + shift) with the product and the sum rounded separately,
// as the plain version's two PyTorch ops round them: a fused multiply-add
// can flip the sign of a value next to 0, and with it K5's ReLU mask,
// which passes or drops a whole da term
__device__ __forceinline__ float affine_relu(float x, float scale, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, scale), shift), 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same four 8x8 matrices, each transposed on its way into the registers:
// lane i gets column i / 4, rows 2 (i % 4) and 2 (i % 4) + 1 of the stored
// matrix, so a [pixel][channel] tile becomes mma's channel-major operand
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 bf2_to_f2(unsigned u) {  // exact
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned f2_to_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the raw halo a lane loads: VW bf16 channels
template <int VW>
using HaloRaw = std::conditional_t<
    VW == 8, uint4, std::conditional_t<VW == 4, uint2, __nv_bfloat16>>;

// One block: the tile of MMA_PIXELS pixels at (blockIdx.y, image
// blockIdx.z), 1 << TWL wide, over the channel chunks of split blockIdx.x
// (of gridDim.x splits, in order). One split: the block adds the bias,
// stores y and, with STATS, writes its sums to part (2, n_tiles, F). More:
// it writes its f32 partial y to ypart (split, tile, MMA_PIXELS, MMA_N) and
// conv3x3_fwd_finish_kernel does the rest.
template <int TWL, int VW, bool STATS>
__global__ void __launch_bounds__(MMA_THREADS, VW > 1 ? 3 : 2) conv3x3_fwd_mma_kernel(
    const __nv_bfloat16* x, int ldx, const float* __restrict__ scale,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* y, int ldy,
    float* __restrict__ part, float* __restrict__ ypart, int H, int W, int C,
    int F) {
  static_assert(VW == 8 || VW == 4 || VW == 1, "a lane loads 8, 4 or 1 channels");
  constexpr int TW = 1 << TWL, HP = TW + 2;     // tile width, halo row pitch
  constexpr int N_HALO = (MMA_PIXELS / TW + 2) * HP;  // halo positions
  static_assert(N_HALO <= MMA_HALO, "the halo does not fit its shared memory");
  // two stages of the activated halo [pos][c] and the weights [tap][f][c]
  __shared__ __align__(16) __nv_bfloat16 s_a[2][MMA_HALO * GP];
  __shared__ __align__(16) __nv_bfloat16 s_w[2][9 * MMA_N * GP];
  __shared__ float s_red[STATS ? 2 * (MMA_THREADS / 32) * MMA_N : 1];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_w = (W + TW - 1) / TW;
  const int w0 = (blockIdx.y % tiles_w) * TW, h0 = (blockIdx.y / tiles_w) * (MMA_PIXELS / TW);
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * H * W * ldx;
  __nv_bfloat16* yb = y + (size_t)blockIdx.z * H * W * ldy;
  const size_t n_tiles = (size_t)gridDim.z * gridDim.y;
  const size_t sb = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  // split s of S takes chunks [s*n/S, (s+1)*n/S): none empty for S <= n
  const int n_chunks = (C + CC - 1) / CC;
  const int k_begin = blockIdx.x * n_chunks / gridDim.x;
  const int k_end = (blockIdx.x + 1) * n_chunks / gridDim.x;
  // pixel m of the tile: (h0 + m / TW, w0 + m % TW)
  auto inside = [&](int m) { return h0 + m / TW < H && w0 + m % TW < W; };
  auto row = [&](int m) { return ((size_t)(h0 + m / TW) * W + w0 + m % TW) * ldy; };

  // Staging a chunk: LP lanes per halo position, VW channels per lane, the
  // same channels at every step; LPW lanes per weight row (tap, c), a
  // channel pair or one value of f each. Every load of the chunk (raw x,
  // weights, scale, shift) is issued before the first store; x is
  // activated in registers on its way to shared memory.
  constexpr int LP = 16 / VW;
  constexpr int A_STEPS = (N_HALO * LP + MMA_THREADS - 1) / MMA_THREADS;
  constexpr int LPW = VW > 1 ? 8 : 16, FPL = 16 / LPW;
  constexpr int W_STEPS = (9 * CC * LPW + MMA_THREADS - 1) / MMA_THREADS;
  using RawA = HaloRaw<VW>;
  using RawW = std::conditional_t<(VW > 1), unsigned, __nv_bfloat16>;
  const int ch0 = (tid % LP) * VW, f0 = (tid % LPW) * FPL;
  int off[A_STEPS];  // the halo position's row in the image, or -1
#pragma unroll
  for (int k = 0; k < A_STEPS; ++k) {
    const int pos = tid / LP + k * (MMA_THREADS / LP);
    const int gh = h0 + pos / HP - 1, gw = w0 + pos % HP - 1;
    off[k] = pos < N_HALO && gh >= 0 && gh < H && gw >= 0 && gw < W
                 ? (gh * W + gw) * ldx : -1;
  }
  auto stage_chunk = [&](int k, int stage) {
    const int c0 = k * CC;
    RawA ra[A_STEPS];
    RawW rw[W_STEPS];
    float sc[VW], sh[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const int gc = c0 + ch0 + j;
      sc[j] = gc < C ? scale[gc] : 0.f;
      sh[j] = gc < C ? shift[gc] : 0.f;
    }
#pragma unroll
    for (int k2 = 0; k2 < A_STEPS; ++k2) {
      // a vector that starts below C ends inside the row (see the header)
      const bool ok = off[k2] >= 0 && c0 + ch0 < C;
      if constexpr (VW == 8) {
        ra[k2] = make_uint4(0, 0, 0, 0);
        if (ok) ra[k2] = *reinterpret_cast<const uint4*>(xb + off[k2] + c0 + ch0);
      } else if constexpr (VW == 4) {
        ra[k2] = make_uint2(0, 0);
        if (ok) ra[k2] = *reinterpret_cast<const uint2*>(xb + off[k2] + c0 + ch0);
      } else {
        ra[k2] = __float2bfloat16(0.f);
        if (ok) ra[k2] = xb[off[k2] + c0 + ch0];
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < W_STEPS; ++k2) {  // weight row (tap, c) = e
      const int e = tid / LPW + k2 * (MMA_THREADS / LPW), c = e % CC, tap = e / CC;
      const size_t p = ((size_t)tap * C + c0 + c) * F + f0;
      const bool ok = e < 9 * CC && c0 + c < C && f0 < F;
      if constexpr (VW > 1) rw[k2] = ok ? *reinterpret_cast<const unsigned*>(w + p) : 0u;
      else rw[k2] = ok ? w[p] : __float2bfloat16(0.f);
    }
    const int nv = C - c0 - ch0;  // channels of this lane below C
#pragma unroll
    for (int k2 = 0; k2 < A_STEPS; ++k2) {
      const int pos = tid / LP + k2 * (MMA_THREADS / LP);
      if (pos >= N_HALO) continue;
      const bool in = off[k2] >= 0;
      if constexpr (VW > 1) {
        unsigned r[VW / 2], o[VW / 2];
        if constexpr (VW == 8) {
          r[0] = ra[k2].x; r[1] = ra[k2].y; r[2] = ra[k2].z; r[3] = ra[k2].w;
        } else {
          r[0] = ra[k2].x; r[1] = ra[k2].y;
        }
#pragma unroll
        for (int q = 0; q < VW / 2; ++q) {
          const float2 v = bf2_to_f2(r[q]);
          const float a0 = in && 2 * q < nv ? affine_relu(v.x, sc[2 * q], sh[2 * q]) : 0.f;
          const float a1 = in && 2 * q + 1 < nv ? affine_relu(v.y, sc[2 * q + 1], sh[2 * q + 1]) : 0.f;
          o[q] = f2_to_bf2(a0, a1);
        }
        if constexpr (VW == 8)
          *reinterpret_cast<uint4*>(&s_a[stage][pos * GP + ch0]) = make_uint4(o[0], o[1], o[2], o[3]);
        else
          *reinterpret_cast<uint2*>(&s_a[stage][pos * GP + ch0]) = make_uint2(o[0], o[1]);
      } else {
        const float a = in && nv > 0 ? affine_relu(__bfloat162float(ra[k2]), sc[0], sh[0]) : 0.f;
        s_a[stage][pos * GP + ch0] = __float2bfloat16(a);
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < W_STEPS; ++k2) {  // [tap][f][c]: transposed
      const int e = tid / LPW + k2 * (MMA_THREADS / LPW), c = e % CC, tap = e / CC;
      if (e >= 9 * CC) continue;
      __nv_bfloat16* d = &s_w[stage][(tap * MMA_N + f0) * GP + c];
      if constexpr (VW > 1) {
        d[0] = __ushort_as_bfloat16((unsigned short)(rw[k2] & 0xffffu));
        d[GP] = __ushort_as_bfloat16((unsigned short)(rw[k2] >> 16));
      } else {
        d[0] = rw[k2];
      }
    }
  };

  // The GEMM: warp w owns pixels [32w, 32w + 32) as two m16 tiles and the
  // MMA_N output channels as two n8 tiles. Output pixel (r, x) of tap
  // (ky, kx) reads the halo at (r + ky, x + kx); the tap's B is W[ky, kx,
  // c0:c0+16, 0:16], [n][k] in shared memory as mma's col operand.
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  unsigned a_base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // ldmatrix row: pixel lane % 16, k half lane / 16
    const int m = warp * 32 + i * 16 + lane % 16;
    a_base[i] = smem_addr(&s_a[0][((m / TW) * HP + m % TW) * GP + (lane / 16) * 8]);
  }
  // B rows: channel (lane / 16) * 8 + lane % 8, k half (lane / 8) % 2
  const unsigned b_base =
      smem_addr(&s_w[0][((lane / 16) * 8 + lane % 8) * GP + ((lane / 8) % 2) * 8]);
  constexpr unsigned A_STAGE = 2 * MMA_HALO * GP, W_STAGE = 2 * 9 * MMA_N * GP;  // bytes

  if (k_begin < k_end) stage_chunk(k_begin, 0);
  __syncthreads();
  for (int k = k_begin; k < k_end; ++k) {
    const int stage = (k - k_begin) & 1;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        unsigned a[2][4], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(a_base[i] + stage * A_STAGE + 2 * GP * (ky * HP + kx), a[i]);
        ldmatrix_x4(b_base + stage * W_STAGE + 2 * GP * ((ky * 3 + kx) * MMA_N), b);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[i][nt], a[i], b[2 * nt], b[2 * nt + 1]);
      }
    // the next chunk into the other stage, while this block's slower warps
    // and the SM's other blocks run their MMAs: one barrier a chunk
    if (k + 1 < k_end) stage_chunk(k + 1, stage ^ 1);
    __syncthreads();
  }

  // Epilogue from the fragments: thread (g, t) = (lane / 4, lane % 4) holds
  // pixels row0 + g (accumulators 0, 1) and row0 + 8 + g (2, 3) of each m16
  // tile and the channel pair nt*8 + 2t + {0, 1}.
  const int g = lane / 4, t = lane % 4;
  if (gridDim.x > 1) {  // f32 partial y of this split, every pixel and channel
    float* yp = ypart + (blockIdx.x * n_tiles + sb) * MMA_PIXELS * MMA_N;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = warp * 32 + i * 16 + half * 8 + g;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<float2*>(yp + m * MMA_N + nt * 8 + 2 * t) =
              make_float2(acc[i][nt][2 * half], acc[i][nt][2 * half + 1]);
      }
    return;
  }
  // add the bias, store the rounded y as channel pairs, and (STATS) sum y
  // and y^2 of the stored values; channels >= F hold 0 and are not stored
  float2 bv[2], s1[2], s2[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int f = nt * 8 + 2 * t;
    bv[nt] = make_float2(bias && f < F ? bias[f] : 0.f, bias && f + 1 < F ? bias[f + 1] : 0.f);
    s1[nt] = s2[nt] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp * 32 + i * 16 + half * 8 + g;
      if (!inside(m)) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int f = nt * 8 + 2 * t;
        const __nv_bfloat162 yv = __floats2bfloat162_rn(acc[i][nt][2 * half] + bv[nt].x,
                                                        acc[i][nt][2 * half + 1] + bv[nt].y);
        if constexpr (VW > 1) {
          if (f < F) *reinterpret_cast<__nv_bfloat162*>(yb + row(m) + f) = yv;
        } else {
          if (f < F) yb[row(m) + f] = yv.x;
          if (f + 1 < F) yb[row(m) + f + 1] = yv.y;
        }
        if constexpr (STATS) {
          const float2 v = __bfloat1622float2(yv);
          s1[nt].x += v.x;
          s1[nt].y += v.y;
          s2[nt].x = fmaf(v.x, v.x, s2[nt].x);
          s2[nt].y = fmaf(v.y, v.y, s2[nt].y);
        }
      }
    }
  if constexpr (STATS) {
    // over the 8 lanes of one channel, then over the warps in order
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float a = j ? s1[nt].y : s1[nt].x, d = j ? s2[nt].y : s2[nt].x;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, o);
          d += __shfl_xor_sync(0xffffffffu, d, o);
        }
        if (g == 0) {
          const int f = nt * 8 + 2 * t + j;
          s_red[(warp * 2) * MMA_N + f] = a;
          s_red[(warp * 2 + 1) * MMA_N + f] = d;
        }
      }
    __syncthreads();
    if (tid < 2 * F) {
      const int k = tid / F, f = tid % F;
      float s = 0.f;
      for (int i = 0; i < MMA_THREADS / 32; ++i) s += s_red[(i * 2 + k) * MMA_N + f];
      part[(k * n_tiles + sb) * F + f] = s;
    }
  }
}

// The second pass when the chunks were split: per tile (blockIdx.x, image
// blockIdx.y), thread m sums pixel m's partial y over the splits in order,
// adds the bias, stores the rounded y and, with STATS, the tile's sums as
// above.
template <bool STATS>
__global__ void __launch_bounds__(MMA_PIXELS) conv3x3_fwd_finish_kernel(
    __nv_bfloat16* y, int ldy, const float* __restrict__ bias,
    const float* __restrict__ ypart, float* __restrict__ part, int H, int W,
    int F, int n_split, int tile_w) {
  __shared__ float s_red[STATS ? 2 * (MMA_PIXELS / 32) * MMA_N : 1];
  const int m = threadIdx.x, warp = m / 32, lane = m % 32;
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int gh = (blockIdx.x / tiles_w) * (MMA_PIXELS / tile_w) + m / tile_w;
  const int gw = (blockIdx.x % tiles_w) * tile_w + m % tile_w;
  const size_t n_tiles = (size_t)gridDim.y * gridDim.x;
  const size_t sb = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float acc[MMA_N];
#pragma unroll
  for (int f = 0; f < MMA_N; ++f) acc[f] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float4* p = reinterpret_cast<const float4*>(
        ypart + ((s * n_tiles + sb) * MMA_PIXELS + m) * MMA_N);
#pragma unroll
    for (int q = 0; q < MMA_N / 4; ++q) {
      const float4 v = p[q];
      acc[4 * q] += v.x;
      acc[4 * q + 1] += v.y;
      acc[4 * q + 2] += v.z;
      acc[4 * q + 3] += v.w;
    }
  }
  const bool in = gh < H && gw < W;
  __nv_bfloat16* yp = y + ((size_t)blockIdx.y * H * W + (size_t)gh * W + gw) * ldy;
#pragma unroll
  for (int f = 0; f < MMA_N; ++f) {
    float a = 0.f, d = 0.f;
    if (in && f < F) {
      const __nv_bfloat16 yv = __float2bfloat16(acc[f] + (bias ? bias[f] : 0.f));
      yp[f] = yv;
      a = __bfloat162float(yv);
      d = a * a;
    }
    if constexpr (STATS) {
      a = warp_sum(a);
      d = warp_sum(d);
      if (lane == 0) {
        s_red[(warp * 2) * MMA_N + f] = a;
        s_red[(warp * 2 + 1) * MMA_N + f] = d;
      }
    }
  }
  if constexpr (STATS) {
    __syncthreads();
    if (m < 2 * F) {
      const int k = m / F, f = m % F;
      float s = 0.f;
      for (int i = 0; i < MMA_PIXELS / 32; ++i) s += s_red[(i * 2 + k) * MMA_N + f];
      part[(k * n_tiles + sb) * F + f] = s;
    }
  }
}

bool mma_tile_width(int tw) { return tw == 32 || tw == 16 || tw == 8; }

int mma_tiles(int n, int t) { return (n + t - 1) / t; }

// Launch the forward (and its finish pass when n_split > 1) on stream s.
// tile_w in {32, 16, 8}; vw in {8, 4, 1} as the header requires (4 only
// where VW4: a caller instantiates the paths it takes); ypart:
// (n_split, B * tiles, MMA_PIXELS, MMA_N) f32 when n_split > 1.
template <bool STATS, bool VW4>
cudaError_t launch_conv3x3_fwd_mma(const __nv_bfloat16* x, int ldx, const float* scale,
                                   const float* shift, const __nv_bfloat16* w,
                                   const float* bias, __nv_bfloat16* y, int ldy,
                                   float* part, float* ypart, int B, int H, int W,
                                   int C, int F, int n_split, int tile_w, int vw,
                                   cudaStream_t s) {
  const int tiles_img = mma_tiles(H, MMA_PIXELS / tile_w) * mma_tiles(W, tile_w);
  const dim3 grid(n_split, tiles_img, B);
#define CONV3X3_LAUNCH(TWL, VW)                                                     \
  conv3x3_fwd_mma_kernel<TWL, VW, STATS><<<grid, MMA_THREADS, 0, s>>>(              \
      x, ldx, scale, shift, w, bias, y, ldy, part, ypart, H, W, C, F)
  switch (tile_w * 16 + vw) {
    case 32 * 16 + 8: CONV3X3_LAUNCH(5, 8); break;
    case 32 * 16 + 4:
      if constexpr (VW4) CONV3X3_LAUNCH(5, 4); else return cudaErrorInvalidValue;
      break;
    case 32 * 16 + 1: CONV3X3_LAUNCH(5, 1); break;
    case 16 * 16 + 8: CONV3X3_LAUNCH(4, 8); break;
    case 16 * 16 + 4:
      if constexpr (VW4) CONV3X3_LAUNCH(4, 4); else return cudaErrorInvalidValue;
      break;
    case 16 * 16 + 1: CONV3X3_LAUNCH(4, 1); break;
    case 8 * 16 + 8: CONV3X3_LAUNCH(3, 8); break;
    case 8 * 16 + 4:
      if constexpr (VW4) CONV3X3_LAUNCH(3, 4); else return cudaErrorInvalidValue;
      break;
    case 8 * 16 + 1: CONV3X3_LAUNCH(3, 1); break;
    default: return cudaErrorInvalidValue;
  }
#undef CONV3X3_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  conv3x3_fwd_finish_kernel<STATS><<<dim3(tiles_img, B), MMA_PIXELS, 0, s>>>(
      y, ldy, bias, ypart, part, H, W, F, n_split, tile_w);
  return cudaGetLastError();
}

}  // namespace
