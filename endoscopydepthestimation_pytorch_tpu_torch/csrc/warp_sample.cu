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
// 10.5 MB, out 10.5 MB) and the backward ~37 MB: a floor of ~10 us each at
// 3.35 TB/s (derived from the shapes, not measured). Neighbouring threads
// take neighbouring queries, whose taps lie on neighbouring texels for a
// smooth warp, so the gathers coalesce well and the image stays in L2
// (50 MB).
//
// Design (simple first): one thread per query (b, q). C is 1 or 2; a
// texel's two channels are one 8-byte load.
// At an integer coordinate the derivative is the floor-based one-sided one
// (taps x0 and x0+1), as in the Pallas kernel and the gather's autodiff.
//
// The backward's dimg is a scatter, which the Pallas kernel sums over its
// sequential grid axis in a fixed order. Here it is the same bit for bit
// on every run, with no float atomics, in four kernels and a scan:
//   1. per query: dpx and dpy (per query, deterministic), and an integer
//      count of the queries in each cell, a query's cell being its top-left
//      tap (x0, y0) (integer atomics: the counts do not depend on order);
//   2. the caller's exclusive scan of the counts (torch.cumsum) gives each
//      cell its segment of a query list;
//   3. per query: its index into a free slot of its cell's segment;
//   4. per cell: its segment sorted by query index (insertion sort for a
//      few entries, heapsort past 16, so a warp that piles every query into
//      one cell costs O(n log n), not O(n^2));
//   5. per texel: the 4 cells whose taps include it, in a fixed order, each
//      over its queries in index order, recomputing each query's weight as
//      the forward does; every channel of dimg is written (0 past CG).
// Each query's contribution is the f32 product the atomics added before;
// only the order of the sums is fixed now. Scratch: 3 ints per cell and
// one per query (~26 MB at the train step's shape).
//
// NaN: a NaN coordinate gives NaN weights, and every tap's value (0 for an
// invalid tap) is multiplied by them, so the sample is NaN, as the Pallas
// tent max(0, NaN) gives. Its integer tap index comes from
// __float2int_rz(NaN), which PTX defines as 0, so no read goes astray (and
// its NaN reaches dimg at the 4 texels of cell (0, 0), as the scatter's
// did). Nothing tests for NaN and skips taps.
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

// A query's cell: its top-left tap (x0, y0). Cells with -1 <= x0 <= W-1
// and -1 <= y0 <= H-1 hold at least one valid tap: (H+1) x (W+1) cells an
// image; -1 for a query whose taps all lie outside.
__device__ __forceinline__ int cell_of(const Taps& t, int b, int H, int W) {
  if (t.x0 < -1 || t.x0 > W - 1 || t.y0 < -1 || t.y0 > H - 1) return -1;
  return (b * (H + 1) + t.y0 + 1) * (W + 1) + t.x0 + 1;
}

// K3 step 1. CG: channels that carry a gradient (the first CG of the CS
// stored in img and g); the others are not read.
template <int CG>
__global__ void __launch_bounds__(NT) warp_sample_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ g,
    float* __restrict__ dpx, float* __restrict__ dpy,
    int* __restrict__ count, int B, int H, int W, int CS, long long Q) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)B * Q) return;
  const int b = (int)(i / Q);
  const Taps t = taps_of(px[i], py[i], H, W);
  float v[4][CG];
  gather<CG>(img + (size_t)b * H * W * CS, t, W, CS, v);
  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    const float gc = g[(size_t)i * CS + c];
    gx += gc * ((1.f - t.wy) * (v[1][c] - v[0][c]) +
                t.wy * (v[3][c] - v[2][c]));
    gy += gc * ((1.f - t.wx) * (v[2][c] - v[0][c]) +
                t.wx * (v[3][c] - v[1][c]));
  }
  dpx[i] = gx;
  dpy[i] = gy;
  const int cell = cell_of(t, b, H, W);
  if (cell >= 0) atomicAdd(count + cell, 1);
}

// K3 step 3: each query's index into a free slot of its cell's segment
__global__ void __launch_bounds__(NT) place_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    int* __restrict__ cursor, int* __restrict__ order, int B, int H, int W,
    long long Q) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)B * Q) return;
  const int cell = cell_of(taps_of(px[i], py[i], H, W), (int)(i / Q), H, W);
  if (cell >= 0) order[atomicAdd(cursor + cell, 1)] = (int)i;
}

// K3 step 4: each cell's segment of query indices in ascending order
__global__ void __launch_bounds__(NT) sort_kernel(
    const int* __restrict__ count, const int* __restrict__ end,
    int* __restrict__ order, int n_cells) {
  const int cell = blockIdx.x * NT + threadIdx.x;
  if (cell >= n_cells) return;
  const int n = count[cell];
  int* a = order + end[cell] - n;
  if (n <= 16) {
    for (int i = 1; i < n; ++i) {
      const int v = a[i];
      int j = i - 1;
      for (; j >= 0 && a[j] > v; --j) a[j + 1] = a[j];
      a[j + 1] = v;
    }
    return;
  }
  auto sift = [a](int root, int size) {
    for (int child = 2 * root + 1; child < size; child = 2 * root + 1) {
      if (child + 1 < size && a[child] < a[child + 1]) ++child;
      if (a[root] >= a[child]) return;
      const int v = a[root];
      a[root] = a[child];
      a[child] = v;
      root = child;
    }
  };
  for (int i = n / 2 - 1; i >= 0; --i) sift(i, n);
  for (int size = n - 1; size > 0; --size) {
    const int v = a[0];
    a[0] = a[size];
    a[size] = v;
    sift(0, size);
  }
}

// K3 step 5: dimg of one texel (b, y, x) from the queries of the 4 cells
// whose taps include it: tap k = (k >> 1, k & 1) of cell (y, x) - k's
// offset, in the order k = 0..3, each cell's queries in index order
template <int CG>
__global__ void __launch_bounds__(NT) dimg_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ g, const int* __restrict__ count,
    const int* __restrict__ end, const int* __restrict__ order,
    float* __restrict__ dimg, int B, int H, int W, int CS) {
  const long long j = (long long)blockIdx.x * NT + threadIdx.x;
  if (j >= (long long)B * H * W) return;
  const int x = (int)(j % W), y = (int)((j / W) % H), b = (int)(j / ((long long)H * W));
  float acc[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ky = k >> 1, kx = k & 1;
    const int cell = (b * (H + 1) + y - ky + 1) * (W + 1) + x - kx + 1;
    const int stop = end[cell];
    for (int e = stop - count[cell]; e < stop; ++e) {
      const int i = order[e];
      const Taps t = taps_of(px[i], py[i], H, W);
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        // the adjoint of the forward's order: g through the row mix first;
        // the product rounded before the sum, as the scatter adds it
        const float gc = g[(size_t)i * CS + c];
        const float gr = gc * (ky ? t.wy : 1.f - t.wy);
        acc[c] = __fadd_rn(acc[c], __fmul_rn(gr, kx ? t.wx : 1.f - t.wx));
      }
    }
  }
  float* d = dimg + (size_t)j * CS;
#pragma unroll
  for (int c = 0; c < MAX_CHANNELS; ++c)
    if (c < CS) d[c] = c < CG ? acc[c] : 0.f;
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

bool bad_bwd_dims(int B, int H, int W, int C, int CG, int Hq, int Wq) {
  return B < 1 || H < 1 || W < 1 || Hq < 1 || Wq < 1 || C < 1 ||
         C > MAX_CHANNELS || CG < 1 || CG > C ||
         (long long)B * Hq * Wq > INT_MAX ||
         (long long)B * (H + 1) * (W + 1) > INT_MAX;
}

// K3 in two calls around the caller's scan. img and g (B, H, W, C) /
// (B, Hq, Wq, C), dpx/dpy (B, Hq, Wq); all f32, contiguous. Only the first
// CG channels are read (CG = 1: the grad-first variant). count: the
// B*(H+1)*(W+1) cells' int32 counts, zeroed by the caller.
int warp_sample_bwd_count(const void* img, const void* px, const void* py,
                          const void* g, void* dpx, void* dpy, void* count,
                          int B, int H, int W, int C, int CG, int Hq, int Wq,
                          void* stream) {
  if (bad_bwd_dims(B, H, W, C, CG, Hq, Wq)) return (int)cudaErrorInvalidValue;
  const long long Q = (long long)Hq * Wq;
  const unsigned grid = blocks_for((long long)B * Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* gg = static_cast<const float*>(g);
  float* dx = static_cast<float*>(dpx);
  float* dy = static_cast<float*>(dpy);
  int* n = static_cast<int*>(count);
  if (CG == 1)
    warp_sample_bwd_kernel<1><<<grid, NT, 0, s>>>(im, x, y, gg, dx, dy, n, B, H, W, C, Q);
  else
    warp_sample_bwd_kernel<2><<<grid, NT, 0, s>>>(im, x, y, gg, dx, dy, n, B, H, W, C, Q);
  return (int)cudaGetLastError();
}

// end: the inclusive scan of count; cursor: end - count, advanced here;
// order: (B*Hq*Wq,) int32 scratch; dimg (B, H, W, C) f32, every channel
// written.
int warp_sample_bwd_dimg(const void* px, const void* py, const void* g,
                         const void* count, const void* end, void* cursor,
                         void* order, void* dimg, int B, int H, int W, int C,
                         int CG, int Hq, int Wq, void* stream) {
  if (bad_bwd_dims(B, H, W, C, CG, Hq, Wq)) return (int)cudaErrorInvalidValue;
  const long long Q = (long long)Hq * Wq;
  const int n_cells = B * (H + 1) * (W + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* gg = static_cast<const float*>(g);
  const int* n = static_cast<const int*>(count);
  const int* e = static_cast<const int*>(end);
  int* o = static_cast<int*>(order);
  float* di = static_cast<float*>(dimg);
  place_kernel<<<blocks_for((long long)B * Q), NT, 0, s>>>(
      x, y, static_cast<int*>(cursor), o, B, H, W, Q);
  sort_kernel<<<blocks_for(n_cells), NT, 0, s>>>(n, e, o, n_cells);
  const unsigned grid = blocks_for((long long)B * H * W);
  if (CG == 1)
    dimg_kernel<1><<<grid, NT, 0, s>>>(x, y, gg, n, e, o, di, B, H, W, C);
  else
    dimg_kernel<2><<<grid, NT, 0, s>>>(x, y, gg, n, e, o, di, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
