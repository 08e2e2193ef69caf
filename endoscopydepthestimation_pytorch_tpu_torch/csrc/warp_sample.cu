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
// 10.5 MB, out 10.5 MB) and the grad-first backward ~42 MB: a floor of
// ~10-13 us each at 3.35 TB/s (derived from the shapes, not measured); the
// backward's scratch and second read of g add up to ~45 MB more.
// Neighbouring threads take neighbouring queries, whose taps lie on
// neighbouring texels for a smooth warp, so the gathers coalesce well and
// the image stays in L2 (50 MB).
//
// The forward (simple first): one thread per query (b, q). C is 1 or 2;
// a texel's two channels are one 8-byte load.
// At an integer coordinate the derivative is the floor-based one-sided one
// (taps x0 and x0+1), as in the Pallas kernel and the gather's autodiff.
//
// The backward's dimg is a scatter, which the Pallas kernel sums over its
// sequential grid axis in a fixed order. Here it is an order-free
// fixed-point scatter: integer addition is associative, so int64 sums
// added with integer atomics give the same bits in any order, and dimg is
// bitwise repeatable with no float atomics, no scan and no sort. One C
// call, four launches on the caller's stream:
//   1. cudaMemsetAsync of the scratch (the int64 sums, the non-finite
//      marks, a count of tiles and max|g|'s bits);
//   2. max_grad_kernel: m, the largest finite |g| of the first CG
//      channels (0 when there is none), by an integer atomicMax on its bits
//      (read on the device: no host sync). With e = frexp(m)'s exponent
//      and h = ceil(log2(Hq*Wq)), each contribution d is added as
//      round(d * 2^S), S = 62 - h - e. A texel takes at most one tap of
//      each query of its image, each |d| <= m < 2^e, so |sum| < 2^62: no
//      overflow. One contribution rounds by at most m * 2^(h-62)
//      (2^-45 m at the train step's h = 17);
//   3. warp_sample_bwd_kernel: a CTA takes a 16x64 tile of one image's
//      queries, ROWS a thread; per query dpx and dpy, and the four
//      taps' products gr = g*(ky ? wy : 1-wy), d = gr*(kx ? wx : 1-wx)
//      (f32, rounded each, no contraction), converted with
//      __double2ll_rn((double)d * 2^S). Where the box of the tile's valid
//      taps fits WINDOW int64 entries of shared memory, the CTA sums there
//      (shared 64-bit atomics) and flushes each non-zero entry with one
//      global atomic; for a smooth warp, ~1,100 global atomics a tile
//      instead of 4,096.
//      Another tile (a random or diverging warp) adds each contribution to
//      the global sums directly: the same bits either way;
//   4. dimg_kernel: dimg = (float)((double)sum * 2^-S), every channel
//      written (0 past CG).
// A non-finite product (a NaN coordinate, a non-finite g, or Inf * 0)
// adds nothing and marks its texel and channel, whose dimg is NaN: the
// texels whose f32 scatter would be non-finite. `_backward_plain` in
// ops/warp_sample.py is the same arithmetic in PyTorch (int64
// scatter_add_), bit for bit. Scratch: 9 bytes per texel and channel of
// the first CG (11.8 MB at the train step's shape), from the caller's
// caching allocator.
// On the card the scatter's loads and stores, not its atomics, take most
// of its time, and the three other launches add about two thirds as much
// again (PERF.md; variants of the scatter: torch_warp_tuning.py).
//
// NaN: a NaN coordinate gives NaN weights, and every tap's value (0 for an
// invalid tap) is multiplied by them, so the sample is NaN, as the Pallas
// tent max(0, NaN) gives. Its integer tap index comes from
// __float2int_rz(NaN), which PTX defines as 0, so no read goes astray (and
// its NaN reaches dimg at the 4 texels of cell (0, 0), through the marks).
// Nothing tests for NaN and skips taps.
//
// Later work: fusing the coordinate math of geometry.warp_depth into the
// forward.

#include <climits>

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

// K3's constants. A CTA of the scatter takes a TILE_H x TILE_W tile of one
// image's queries, ROWS a thread, and sums in WINDOW shared int64 entries
// (40 KB) where the box of the tile's valid taps fits.
constexpr int TILE_H = 16, TILE_W = 64;
constexpr int ROWS = TILE_H * TILE_W / NT;
constexpr int WINDOW = 5120;
// the scatter's CTAs an SM: 5 windows fit in its 228 KB of shared memory,
// and 5 x NT threads at <= 48 registers in its 64 K (at 56, 4 CTAs fit and
// the scatter is slower)
constexpr int BWD_CTAS = 5;
constexpr int MAX_BLOCKS = 528;  // the max pass: 4 CTAs an SM of 132
constexpr unsigned NAN_BITS = 0x7fc00000u;  // PyTorch's NaN

// 2^s exactly, for s inside a double's normal range
__device__ __forceinline__ double pow2(int s) {
  return __longlong_as_double((long long)(1023 + s) << 52);
}

// S of the fixed-point sums: 62 - h - e, e = frexp(max|g|)'s exponent
// (frexpf(0) gives e = 0)
__device__ __forceinline__ int fixed_shift(const unsigned* max_bits, int h) {
  int e;
  frexpf(__uint_as_float(*max_bits), &e);
  return 62 - h - e;
}

// K3 step 2: max_bits = the bits of the largest finite |g| over the first CG
// channels. Non-negative floats order as their bits do, so an integer
// atomicMax (one a CTA) gives the same word in any order.
template <int CG, int CS>
__global__ void __launch_bounds__(NT) max_grad_kernel(
    const float* __restrict__ g, unsigned* __restrict__ max_bits, long long n) {
  unsigned m = 0;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    float v[CS];
    load_texel<CS>(g + i * CS, v);
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const unsigned bits = __float_as_uint(v[c]) & 0x7fffffffu;
      if (bits < 0x7f800000u) m = max(m, bits);  // finite only
    }
  }
  __shared__ unsigned part[NT / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xffffffffu, threadIdx.x < NT / 32 ? part[threadIdx.x] : 0u);
    if (threadIdx.x == 0 && m) atomicMax(max_bits, m);
  }
}

// K3 step 3: dpx and dpy per query, and each valid tap's product added to
// the int64 sums of its texel (b, y, x, c) at ((b*H + y)*W + x)*CG + c,
// through the shared window where the tile's box fits and straight to the
// global sums otherwise.
template <int CG, int CS>
__global__ void __launch_bounds__(NT, BWD_CTAS) warp_sample_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ g,
    float* __restrict__ dpx, float* __restrict__ dpy,
    unsigned long long* __restrict__ acc, unsigned char* __restrict__ marks,
    const unsigned* __restrict__ max_bits,
    unsigned long long* __restrict__ tiles_fit, int H, int W, int Hq, int Wq,
    int h) {
  __shared__ unsigned long long window[WINDOW];
  __shared__ int box[4];  // the tile's valid taps: x_lo, y_lo, x_hi, y_hi
  const int b = blockIdx.z;
  const int qx = blockIdx.x * TILE_W + threadIdx.x % TILE_W;
  const int qy0 = blockIdx.y * TILE_H + threadIdx.x / TILE_W;
  const long long base = (long long)b * Hq * Wq;
  const size_t texel0 = (size_t)b * H * W;  // image b's first texel
  float x[ROWS], y[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qy = qy0 + r * (NT / TILE_W);
    const bool live = qx < Wq && qy < Hq;
    x[r] = live ? px[base + (long long)qy * Wq + qx] : 0.f;
    y[r] = live ? py[base + (long long)qy * Wq + qx] : 0.f;
  }

  int xl = INT_MAX, yl = INT_MAX, xh = INT_MIN, yh = INT_MIN;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (qx >= Wq || qy0 + r * (NT / TILE_W) >= Hq) continue;
    const Taps t = taps_of(x[r], y[r], H, W);
    if (!(t.vx0 || t.vx1) || !(t.vy0 || t.vy1)) continue;  // no valid tap
    xl = min(xl, t.vx0 ? t.x0 : t.x0 + 1);
    xh = max(xh, t.vx1 ? t.x0 + 1 : t.x0);
    yl = min(yl, t.vy0 ? t.y0 : t.y0 + 1);
    yh = max(yh, t.vy1 ? t.y0 + 1 : t.y0);
  }
  if (threadIdx.x == 0) {
    box[0] = box[1] = INT_MAX;
    box[2] = box[3] = INT_MIN;
  }
  __syncthreads();
  xl = __reduce_min_sync(0xffffffffu, xl);
  yl = __reduce_min_sync(0xffffffffu, yl);
  xh = __reduce_max_sync(0xffffffffu, xh);
  yh = __reduce_max_sync(0xffffffffu, yh);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(box + 0, xl);
    atomicMin(box + 1, yl);
    atomicMax(box + 2, xh);
    atomicMax(box + 3, yh);
  }
  __syncthreads();
  const int lo_x = box[0], lo_y = box[1];
  int bw = 0;
  bool in_window = false;
  if (box[2] >= lo_x) {
    bw = box[2] - lo_x + 1;
    in_window = (long long)bw * (box[3] - lo_y + 1) * CG <= WINDOW;
  }
  if (in_window) {
    const int n_win = bw * (box[3] - lo_y + 1) * CG;
    for (int j = threadIdx.x; j < n_win; j += NT) window[j] = 0ull;
    if (threadIdx.x == 0) atomicAdd(tiles_fit, 1ull);
    __syncthreads();
  }

  const double scale = pow2(fixed_shift(max_bits, h));
  const float* im = img + texel0 * CS;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qy = qy0 + r * (NT / TILE_W);
    if (qx >= Wq || qy >= Hq) continue;
    const long long i = base + (long long)qy * Wq + qx;
    const Taps t = taps_of(x[r], y[r], H, W);
    float v[4][CG];
    gather<CG>(im, t, W, CS, v);
    float gq[CS];
    load_texel<CS>(g + i * CS, gq);
    float gx = 0.f, gy = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      gx += gq[c] * ((1.f - t.wy) * (v[1][c] - v[0][c]) +
                     t.wy * (v[3][c] - v[2][c]));
      gy += gq[c] * ((1.f - t.wx) * (v[2][c] - v[0][c]) +
                     t.wx * (v[3][c] - v[1][c]));
    }
    dpx[i] = gx;
    dpy[i] = gy;
    const bool valid[4] = {t.vy0 && t.vx0, t.vy0 && t.vx1, t.vy1 && t.vx0,
                           t.vy1 && t.vx1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!valid[k]) continue;  // an invalid tap adds nothing
      const int ky = k >> 1, kx = k & 1;
      const int yi = t.y0 + ky, xi = t.x0 + kx;
      const float wr = ky ? t.wy : 1.f - t.wy, wc = kx ? t.wx : 1.f - t.wx;
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        // the adjoint of the forward's order: g through the row mix first
        const float d = __fmul_rn(__fmul_rn(gq[c], wr), wc);
        const size_t at = (texel0 + (size_t)yi * W + xi) * CG + c;
        if (!isfinite(d)) {
          marks[at] = 1;
          continue;
        }
        const long long q = __double2ll_rn(__dmul_rn((double)d, scale));
        if (q == 0) continue;
        if (in_window)
          atomicAdd(window + ((yi - lo_y) * bw + xi - lo_x) * CG + c,
                    (unsigned long long)q);
        else
          atomicAdd(acc + at, (unsigned long long)q);
      }
    }
  }

  if (in_window) {  // the same on every thread of the CTA
    __syncthreads();
    const int n_win = bw * (box[3] - lo_y + 1) * CG;
    for (int j = threadIdx.x; j < n_win; j += NT) {
      const unsigned long long q = window[j];
      if (q == 0ull) continue;
      const int cell = j / CG;
      const int yi = lo_y + cell / bw, xi = lo_x + cell % bw;
      atomicAdd(acc + (texel0 + (size_t)yi * W + xi) * CG + j % CG, q);
    }
  }
}

// K3 step 4: dimg of each texel from its sums; NaN where marked, 0 past CG
template <int CG, int CS>
__global__ void __launch_bounds__(NT) dimg_kernel(
    const long long* __restrict__ acc, const unsigned char* __restrict__ marks,
    const unsigned* __restrict__ max_bits, float* __restrict__ dimg,
    long long n, int h) {
  const long long j = (long long)blockIdx.x * NT + threadIdx.x;
  if (j >= n) return;
  const double inv = pow2(-fixed_shift(max_bits, h));
  float r[CS];
#pragma unroll
  for (int c = 0; c < CS; ++c) {
    r[c] = 0.f;
    if (c < CG)
      r[c] = marks[j * CG + c]
                 ? __uint_as_float(NAN_BITS)
                 : __double2float_rn(__dmul_rn(__ll2double_rn(acc[j * CG + c]), inv));
  }
  float* d = dimg + j * CS;
  if constexpr (CS == 2)
    *reinterpret_cast<float2*>(d) = make_float2(r[0], r[1]);
  else
    d[0] = r[0];
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + NT - 1) / NT); }

// the scratch: n int64 sums, n bytes of marks (padded to 8), then the
// count of tiles summed in shared memory and max|g|'s bits, a word each
// (n = B*H*W*CG)
inline long long marks_bytes(long long n) { return (n + 7) / 8 * 8; }
inline long long scratch_bytes(long long n) { return 8 * n + marks_bytes(n) + 16; }

template <int CG, int CS>
void launch_bwd(const float* img, const float* px, const float* py,
                const float* g, float* dpx, float* dpy, float* dimg,
                unsigned long long* scratch, int B, int H, int W, int Hq,
                int Wq, cudaStream_t s) {
  const long long Q = (long long)Hq * Wq, n = (long long)B * H * W * CG;
  int h = 0;  // ceil(log2(Q)): a texel's queries number at most 2^h
  while ((1LL << h) < Q) ++h;
  unsigned long long* acc = scratch;
  unsigned char* marks = reinterpret_cast<unsigned char*>(acc + n);
  unsigned long long* tiles_fit = acc + n + marks_bytes(n) / 8;
  unsigned* max_bits = reinterpret_cast<unsigned*>(tiles_fit + 1);
  const unsigned reduce_grid = blocks_for((long long)B * Q);
  max_grad_kernel<CG, CS><<<reduce_grid < MAX_BLOCKS ? reduce_grid : MAX_BLOCKS,
                            NT, 0, s>>>(g, max_bits, (long long)B * Q);
  const dim3 tiles((Wq + TILE_W - 1) / TILE_W, (Hq + TILE_H - 1) / TILE_H, B);
  warp_sample_bwd_kernel<CG, CS><<<tiles, NT, 0, s>>>(
      img, px, py, g, dpx, dpy, acc, marks, max_bits, tiles_fit, H, W, Hq, Wq,
      h);
  dimg_kernel<CG, CS><<<blocks_for((long long)B * H * W), NT, 0, s>>>(
      reinterpret_cast<const long long*>(acc), marks, max_bits, dimg,
      (long long)B * H * W, h);
}

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

// The bytes of K3's scratch for an image (B, H, W, *) with CG gradient
// channels.
long long warp_sample_bwd_scratch_bytes(int B, int H, int W, int CG) {
  return scratch_bytes((long long)B * H * W * CG);
}

// K3 in one call. img and g (B, H, W, C) / (B, Hq, Wq, C), dpx/dpy
// (B, Hq, Wq), dimg (B, H, W, C); all f32, contiguous. Only the first CG
// channels are read (CG = 1: the grad-first variant); every channel of
// dimg is written. scratch: at least warp_sample_bwd_scratch_bytes bytes,
// 8-byte aligned, zeroed here.
int warp_sample_bwd(const void* img, const void* px, const void* py,
                    const void* g, void* dpx, void* dpy, void* dimg,
                    void* scratch, long long n_scratch, int B, int H, int W,
                    int C, int CG, int Hq, int Wq, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hq < 1 || Wq < 1 || C < 1 ||
      C > MAX_CHANNELS || CG < 1 || CG > C || B > 65535 ||
      (Hq + TILE_H - 1) / TILE_H > 65535 ||
      (long long)B * Hq * Wq > INT_MAX || (long long)B * H * W * C > INT_MAX ||
      n_scratch < scratch_bytes((long long)B * H * W * CG))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(
      scratch, 0, (size_t)scratch_bytes((long long)B * H * W * CG), s);
  if (rc != cudaSuccess) return (int)rc;
  const float* im = static_cast<const float*>(img);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* gg = static_cast<const float*>(g);
  float* dx = static_cast<float*>(dpx);
  float* dy = static_cast<float*>(dpy);
  float* di = static_cast<float*>(dimg);
  auto* sums = static_cast<unsigned long long*>(scratch);
  if (C == 1)
    launch_bwd<1, 1>(im, x, y, gg, dx, dy, di, sums, B, H, W, Hq, Wq, s);
  else if (CG == 1)
    launch_bwd<1, 2>(im, x, y, gg, dx, dy, di, sums, B, H, W, Hq, Wq, s);
  else
    launch_bwd<2, 2>(im, x, y, gg, dx, dy, di, sums, B, H, W, Hq, Wq, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
