// The train step's optimizer for Hopper (sm_90a): clip by global norm and
// momentum SGD over every parameter tensor in one C call.
//
// Semantics (optax's apply_if_finite(chain(clip_by_global_norm(clip),
// sgd(lr, momentum))) behind the loss gate, as training.sgd_update states
// them): with n = |g| over every element of every gradient,
//   u  = g                      if n < clip, else (g / n) * clip
//   nb = u + momentum * b
//   b  = nb, p = p - lr * nb    only if the loss and every g are finite
// count += (all finite), step += isfinite(loss). A non-finite loss makes n
// NaN. Every product, quotient, sum and difference is rounded on its own
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn: no FMA contraction), so
// the update is the plain path's arithmetic (ops/sgd_update.py
// `_sgd_update_plain`): b and p equal its bits wherever n < clip.
//
// It replaces no TPU kernel: the JAX package leaves the optimizer to
// optax's chain, which XLA fuses. The port's eager loop launched ~21
// kernels a tensor (~8,400 of a FC-DenseNet-103 step's 14,321 device
// operations on an H100, 398 tensors), each a few microseconds of device
// time and ~13-21 us of host time. Here the host makes one C call of three
// launches on the caller's stream:
//   1. sgd_norm_kernel: the tensors' elements, concatenated, split into
//      equal spans, one block a span; each block sums the squares of its
//      gradient elements in f32 in a fixed order and flags a non-finite
//      element; one partial and one flag a block (no float atomics);
//   2. sgd_finish_kernel (one block): the partials summed in a fixed order,
//      n = sqrt(sum), the loss gate, count and step advanced on the device;
//   3. sgd_step_kernel: the update, every element, skipped whole where not
//      every gradient is finite.
// Repeats bit for bit: the spans, the per-thread order and the tree sums
// depend on the tensors' sizes alone.
//
// What bounds it on an H100: memory. The norm reads g (4 bytes an element),
// the step reads p, b, g and writes p, b (20): 24 bytes an element, ~224 MB
// and ~0.067 ms at 3.35 TB/s for FC-DenseNet-103's 9.3 M parameters
// (derived from the shapes). Each thread keeps U loads in flight.
//
// The table of tensors rides in the kernels' parameters (CUDA 12.1 and
// later take up to 32,764 bytes of them), MAX_SLOTS tensors a launch;
// longer lists take one norm and one step launch per MAX_SLOTS. No copy
// of the table to the device, no host synchronisation.
//
// Layouts: p and b share one dense layout, read as flat storage. A
// gradient laid out otherwise (a dense permutation of p's dimensions: the
// engine's dW is (3, 3, C, F) in memory, cuDNN's is channels_last) is
// read through its strides: the step maps p's flat offset to the logical
// index in p's memory order (at most MAX_DIMS dimensions of size > 1) and
// on to g's offset. The norm reads g in its own order (the squares' sum
// does not depend on the layout).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads of a norm or step block
constexpr int FINISH_NT = 1024;  // threads of the finish block
constexpr int U = 4;             // loads in flight a thread
constexpr int MAX_SLOTS = 448;   // tensors a launch
constexpr int MAX_DIMS = 4;      // dimensions of size > 1 of a permuted g
constexpr int NORM_BLOCKS = 1024;          // partials a launch, at most
constexpr int MIN_NORM_SPAN = 4096;        // elements a norm block, at least
constexpr int STEP_SPAN = NT * U * 2;      // elements a step block
constexpr long long MAX_ELEMENTS = 1LL << 30;  // elements a call: int offsets

// A launch's tensors: element offsets of each in their concatenation
// (start[n] = the total).
struct NormTable {
  const float* g[MAX_SLOTS];
  int start[MAX_SLOTS + 1];
  int n;
};

struct StepTable {
  float* p[MAX_SLOTS];
  float* b[MAX_SLOTS];
  const float* g[MAX_SLOTS];
  int start[MAX_SLOTS + 1];
  // g's layout: nd = 0 where g lies as p; else p's nd dimensions of size
  // > 1 in its memory order, outermost first: their sizes (the outermost
  // not needed) and g's strides along them
  int nd[MAX_SLOTS];
  int size[MAX_DIMS - 1][MAX_SLOTS];
  int gstride[MAX_DIMS][MAX_SLOTS];
  int n;
};

// the slot that holds element lo of the concatenation (start[0] <= lo <
// start[n]): the last slot whose start is <= lo, so empty slots are passed
__device__ __forceinline__ int find_slot(const int* start, int n, int lo) {
  int a = 0, b = n;
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (start[m] <= lo) a = m;
    else b = m;
  }
  return a;
}

// the block's sum in a fixed order: shuffles within each warp, then the
// warps' sums by warp 0; thread 0 holds it
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

// launch 1: the partial sum of squares and the non-finite flag of the
// block's span [lo, hi) of the concatenated gradients
__global__ void __launch_bounds__(NT) sgd_norm_kernel(
    const __grid_constant__ NormTable t, int span, float* __restrict__ partial,
    int* __restrict__ nonfinite) {
  const int total = t.start[t.n];
  const int lo = blockIdx.x * span;
  const int hi = span < total - lo ? lo + span : total;
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  int bad = 0;
  for (int k = lo < total ? find_slot(t.start, t.n, lo) : t.n; k < t.n && t.start[k] < hi;
       ++k) {
    const int s = t.start[k];
    const int e = min(hi, t.start[k + 1]) - s;
    const float* __restrict__ g = t.g[k];
    for (int i = max(lo, s) - s + threadIdx.x; i < e; i += NT * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = i + u * NT < e ? g[i + u * NT] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        bad |= !isfinite(v[u]);
        acc[u] = __fadd_rn(acc[u], __fmul_rn(v[u], v[u]));
      }
    }
  }
  float sum = acc[0];
#pragma unroll
  for (int u = 1; u < U; ++u) sum = __fadd_rn(sum, acc[u]);
  sum = block_sum<NT>(sum);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = sum;
    nonfinite[blockIdx.x] = bad;
  }
}

// launch 2: the global norm, the gates, count and step
__global__ void __launch_bounds__(FINISH_NT) sgd_finish_kernel(
    const float* __restrict__ partial, const int* __restrict__ nonfinite,
    int n_partials, const float* __restrict__ loss, float* __restrict__ grad_norm,
    unsigned char* __restrict__ finite, int* __restrict__ all_finite,
    int* __restrict__ count, int* __restrict__ step) {
  float sum = 0.f;
  int bad = 0;
  for (int j = threadIdx.x; j < n_partials; j += FINISH_NT) {
    sum = __fadd_rn(sum, partial[j]);
    bad |= nonfinite[j];
  }
  sum = block_sum<FINISH_NT>(sum);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    const int ok = isfinite(*loss) ? 1 : 0;
    const int all = ok && !bad;
    *grad_norm = ok ? __fsqrt_rn(sum) : __int_as_float(0x7fc00000);  // NaN
    *finite = (unsigned char)ok;
    *all_finite = all;
    *count += all;
    *step += ok;
  }
}

// g's offset of p's flat offset i in slot k (nd > 0)
__device__ __forceinline__ int g_offset(const StepTable& t, int k, int nd, int i) {
  int off = 0;
  for (int d = nd - 1; d > 0; --d) {
    const int s = t.size[d - 1][k];
    off += (i % s) * t.gstride[d][k];
    i /= s;
  }
  return off + i * t.gstride[0][k];
}

// launch 3: the update of the block's span of the concatenated tensors
__global__ void __launch_bounds__(NT) sgd_step_kernel(
    const __grid_constant__ StepTable t, int span, const float* __restrict__ lr,
    const float* __restrict__ grad_norm, const int* __restrict__ all_finite,
    float clip, float momentum) {
  if (!*all_finite) return;
  const float norm = *grad_norm, rate = *lr;
  const bool clipped = !(norm < clip);
  const int total = t.start[t.n];
  const int lo = blockIdx.x * span;
  if (lo >= total) return;
  const int hi = span < total - lo ? lo + span : total;
  for (int k = find_slot(t.start, t.n, lo); k < t.n && t.start[k] < hi; ++k) {
    const int s = t.start[k];
    const int e = min(hi, t.start[k + 1]) - s;
    float* __restrict__ p = t.p[k];
    float* __restrict__ b = t.b[k];
    const float* __restrict__ g = t.g[k];
    const int nd = t.nd[k];
    for (int i = max(lo, s) - s + threadIdx.x; i < e; i += NT * U) {
      float gv[U], bv[U], pv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = i + u * NT;
        if (j < e) {
          gv[u] = g[nd ? g_offset(t, k, nd, j) : j];
          bv[u] = b[j];
          pv[u] = p[j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = i + u * NT;
        if (j < e) {
          const float x = clipped ? __fmul_rn(__fdiv_rn(gv[u], norm), clip) : gv[u];
          const float nb = __fadd_rn(x, __fmul_rn(momentum, bv[u]));
          b[j] = nb;
          p[j] = __fsub_rn(pv[u], __fmul_rn(rate, nb));
        }
      }
    }
  }
}

// a row of the host's permuted layouts: slot, nd, p's sizes along its nd
// dimensions in its memory order and g's strides along them, each padded
// to MAX_DIMS
constexpr int PERM_ROW = 2 + 2 * MAX_DIMS;

inline int chunks_of(int n) { return (n + MAX_SLOTS - 1) / MAX_SLOTS; }

}  // namespace

extern "C" {

int sgd_update_max_dims() { return MAX_DIMS; }

// The bytes of the scratch for n tensors: a partial sum and a flag for each
// norm block of each launch, then the all-finite gate.
long long sgd_update_scratch_bytes(int n) {
  return (long long)chunks_of(n) * NORM_BLOCKS * 8 + 16;
}

// One optimizer step over n tensors. ptrs: 3n device addresses, the n
// parameters, then the n momentum buffers, then the n gradients, f32;
// numel: n element counts (at most MAX_ELEMENTS in all). perm: n_perm
// rows of PERM_ROW ints, in slot order, for the gradients laid out
// otherwise than their parameter. loss, lr: f32
// scalars; grad_norm: f32 and finite: one byte (bool), written; count,
// step: int32, advanced; scratch: sgd_update_scratch_bytes(n) bytes,
// 4-byte aligned. All on the caller's stream; nothing is read back.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments the kernels do not take.
int sgd_update(const unsigned long long* ptrs, const long long* numel, const int* perm,
               int n_perm, int n, const void* loss, const void* lr, float clip,
               float momentum, void* grad_norm, void* finite, void* count, void* step,
               void* scratch, long long scratch_bytes, void* stream) {
  if (n < 1 || n_perm < 0 || n_perm > n || scratch_bytes < sgd_update_scratch_bytes(n))
    return (int)cudaErrorInvalidValue;
  long long total = 0;
  for (int k = 0; k < n; ++k) {
    if (numel[k] < 0) return (int)cudaErrorInvalidValue;
    total += numel[k];
  }
  if (total > MAX_ELEMENTS) return (int)cudaErrorInvalidValue;
  const int chunks = chunks_of(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  int* nonfinite = reinterpret_cast<int*>(partial + (long long)chunks * NORM_BLOCKS);
  int* all_finite = nonfinite + (long long)chunks * NORM_BLOCKS;
  NormTable nt;  // the kernels' parameters, copied at each launch
  StepTable st;
  cudaError_t rc;

  int n_partials = 0;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * MAX_SLOTS, m = n - k0 < MAX_SLOTS ? n - k0 : MAX_SLOTS;
    nt.n = m;
    nt.start[0] = 0;
    for (int j = 0; j < m; ++j) {
      nt.g[j] = reinterpret_cast<const float*>(ptrs[2 * n + k0 + j]);
      nt.start[j + 1] = nt.start[j] + (int)numel[k0 + j];
    }
    const int elems = nt.start[m];
    int span = (elems + NORM_BLOCKS - 1) / NORM_BLOCKS;
    if (span < MIN_NORM_SPAN) span = MIN_NORM_SPAN;
    const int blocks = elems > 0 ? (elems + span - 1) / span : 1;
    sgd_norm_kernel<<<blocks, NT, 0, s>>>(nt, span, partial + n_partials,
                                          nonfinite + n_partials);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    n_partials += blocks;
  }
  sgd_finish_kernel<<<1, FINISH_NT, 0, s>>>(
      partial, nonfinite, n_partials, static_cast<const float*>(loss),
      static_cast<float*>(grad_norm), static_cast<unsigned char*>(finite), all_finite,
      static_cast<int*>(count), static_cast<int*>(step));
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;

  int r = 0;  // perm rows come in slot order
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * MAX_SLOTS, m = n - k0 < MAX_SLOTS ? n - k0 : MAX_SLOTS;
    st.n = m;
    st.start[0] = 0;
    for (int j = 0; j < m; ++j) {
      const int k = k0 + j;
      st.p[j] = reinterpret_cast<float*>(ptrs[k]);
      st.b[j] = reinterpret_cast<float*>(ptrs[n + k]);
      st.g[j] = reinterpret_cast<const float*>(ptrs[2 * n + k]);
      st.start[j + 1] = st.start[j] + (int)numel[k];
      st.nd[j] = 0;
      if (r < n_perm && perm[r * PERM_ROW] == k) {
        const int* row = perm + r * PERM_ROW;
        const int nd = row[1];
        if (nd < 2 || nd > MAX_DIMS) return (int)cudaErrorInvalidValue;
        st.nd[j] = nd;
        for (int d = 1; d < MAX_DIMS; ++d) st.size[d - 1][j] = row[2 + d];
        for (int d = 0; d < MAX_DIMS; ++d) st.gstride[d][j] = row[2 + MAX_DIMS + d];
        ++r;
      }
    }
    const int elems = st.start[m];
    const int blocks = elems > 0 ? (elems + STEP_SPAN - 1) / STEP_SPAN : 1;
    sgd_step_kernel<<<blocks, NT, 0, s>>>(
        st, STEP_SPAN, static_cast<const float*>(lr), static_cast<const float*>(grad_norm),
        all_finite, clip, momentum);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  return r == n_perm ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

}  // extern "C"
