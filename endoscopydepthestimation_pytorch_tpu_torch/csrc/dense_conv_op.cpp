// endodepth::fused_dense_conv registered in C++, for the Python-free serving
// host (csrc/serve_host.cpp). The op library built from this file is copied
// into a serving bundle as ops.so; the host dlopens it before it loads the
// AOTInductor package, whose proxy executor then finds the op by name.
//
// The schema string is the Python registration's (ops/dense_conv.py SCHEMA):
// the tiling comes in as ints that Python chose from the shape when the graph
// was traced. Never load this library into a Python process that imported
// ops/dense_conv.py: the second definition of the op raises.
//
// CUDA: the K1 kernel of csrc/dense_conv.cu (its C entry dense_conv_fwd,
// linked in when the build has CUDA) on the current stream, which is the one
// the host hands the AOTInductor loader. CPU: the plain version in ATen, as
// ops/dense_conv.fused_dense_conv_reference: the affine and ReLU in f32,
// rounded to x's dtype, then a zero-padded 3x3 conv in x's dtype.
#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>

#ifdef ENDODEPTH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int dense_conv_fwd(int dtype, const void* x, const void* scale,
                              const void* shift, const void* w, const void* bias,
                              void* y, void* ypart, int B, int H, int W, int C,
                              int F, int n_split, int tile_w, int vw, void* stream);
extern "C" int dense_conv_max_features();
#endif

namespace {

constexpr int64_t kMaxFeatures = 16;  // the kernel's compiled maximum of F
constexpr int64_t kMmaPixels = 256;   // the bf16 kernel's tile
std::atomic<int64_t> g_launches{0};   // K1 launches in this process

void check(const at::Tensor& x, const at::Tensor& scale, const at::Tensor& shift,
           const at::Tensor& w, const std::optional<at::Tensor>& bias,
           int64_t tile_h, int64_t tile_w, int64_t n_split) {
  TORCH_CHECK(x.dim() == 4, "x must be (B, H, W, C), got ", x.sizes());
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "x must be float32 or bfloat16, got ", x.scalar_type());
  TORCH_CHECK(x.is_contiguous(), "x must be contiguous NHWC");
  const int64_t c = x.size(3);
  TORCH_CHECK(w.dim() == 4 && w.size(0) == 3 && w.size(1) == 3 && w.size(2) == c,
              "w must be (3, 3, ", c, ", F), got ", w.sizes());
  TORCH_CHECK(w.scalar_type() == x.scalar_type() && w.is_contiguous(),
              "w must be contiguous and of x's dtype");
  const int64_t f = w.size(3);
  TORCH_CHECK(f <= kMaxFeatures, "F = ", f, " exceeds the kernel's maximum ",
              kMaxFeatures);
  auto vector = [&](const at::Tensor& t, int64_t n, const char* name) {
    TORCH_CHECK(t.dim() == 1 && t.size(0) == n && t.scalar_type() == at::kFloat &&
                    t.is_contiguous() && t.device() == x.device(),
                name, " must be a contiguous float32 (", n, ",) tensor on x's device");
  };
  vector(scale, c, "scale");
  vector(shift, c, "shift");
  if (bias) vector(*bias, f, "bias");
  TORCH_CHECK(w.device() == x.device(), "w must lie on x's device");
  const bool ok = x.scalar_type() == at::kBFloat16
                      ? tile_h * tile_w == kMmaPixels &&
                            (tile_w == 32 || tile_w == 16 || tile_w == 8) && n_split >= 1
                      : tile_h == 16 && tile_w == 32 && n_split == 1;
  TORCH_CHECK(ok, "no ", x.scalar_type(), " kernel for the tiling (", tile_h, ", ",
              tile_w, ", ", n_split, ")");
}

at::Tensor fused_dense_conv_cpu(const at::Tensor& x, const at::Tensor& scale,
                                const at::Tensor& shift, const at::Tensor& w,
                                const std::optional<at::Tensor>& bias, int64_t tile_h,
                                int64_t tile_w, int64_t n_split) {
  check(x, scale, shift, w, bias, tile_h, tile_w, n_split);
  const auto dtype = x.scalar_type();
  at::Tensor a = at::relu(x.permute({0, 3, 1, 2}).to(at::kFloat) * scale.view({-1, 1, 1}) +
                          shift.view({-1, 1, 1}))
                     .to(dtype);
  std::optional<at::Tensor> b;
  if (bias) b = bias->to(dtype);
  return at::conv2d(a, w.permute({3, 2, 0, 1}), b, 1, 1)
      .permute({0, 2, 3, 1})
      .contiguous();
}

#ifdef ENDODEPTH_CUDA
int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ops/dense_conv.vector_width: bf16 channels a lane loads from x's rows
int vector_width(bool bf16, int64_t c, int64_t f, uintptr_t x, uintptr_t w,
                 uintptr_t y) {
  if (!bf16 || f % 2 || w % 4 || y % 4) return 1;
  for (int vw : {8, 4})
    if (c % vw == 0 && x % (2 * vw) == 0) return vw;
  return 1;
}

at::Tensor fused_dense_conv_cuda(const at::Tensor& x, const at::Tensor& scale,
                                 const at::Tensor& shift, const at::Tensor& w,
                                 const std::optional<at::Tensor>& bias, int64_t tile_h,
                                 int64_t tile_w, int64_t n_split) {
  check(x, scale, shift, w, bias, tile_h, tile_w, n_split);
  TORCH_CHECK(dense_conv_max_features() == kMaxFeatures,
              "dense_conv kernel and op disagree on the maximum feature count");
  const int64_t b = x.size(0), h = x.size(1), wd = x.size(2), c = x.size(3);
  const int64_t f = w.size(3);
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty({b, h, wd, f}, x.options());
  const int vw = vector_width(bf16, c, f, reinterpret_cast<uintptr_t>(x.data_ptr()),
                              reinterpret_cast<uintptr_t>(w.data_ptr()),
                              reinterpret_cast<uintptr_t>(y.data_ptr()));
  // split chunks: the blocks' f32 partial y, summed in order by a second pass
  at::Tensor ypart;
  if (n_split > 1)
    ypart = at::empty({n_split, b * ceil_div(h, tile_h) * ceil_div(wd, tile_w),
                       kMmaPixels, kMaxFeatures},
                      x.options().dtype(at::kFloat));
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  const int rc = dense_conv_fwd(
      bf16 ? 1 : 0, x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
      bias ? bias->data_ptr() : nullptr, y.data_ptr(),
      ypart.defined() ? ypart.data_ptr() : nullptr, b, h, wd, c, f, n_split, tile_w, vw,
      stream);
  TORCH_CHECK(rc == 0, "dense_conv_fwd launch failed: CUDA error ", rc, " for x ",
              x.sizes(), " ", x.scalar_type(), ", F = ", f, ", tiling (", tile_h, ", ",
              tile_w, ", ", n_split, "), ", vw, " channels a lane");
  g_launches.fetch_add(1);
  return y;
}
#endif

}  // namespace

// The host reads K1's launch count through this.
extern "C" int64_t endodepth_dense_conv_launches() { return g_launches.load(); }

TORCH_LIBRARY(endodepth, m) {
  m.def("fused_dense_conv(Tensor x, Tensor scale, Tensor shift, Tensor w, "
        "Tensor? bias, int tile_h, int tile_w, int n_split) -> Tensor");
}

TORCH_LIBRARY_IMPL(endodepth, CPU, m) {
  m.impl("fused_dense_conv", &fused_dense_conv_cpu);
}

#ifdef ENDODEPTH_CUDA
TORCH_LIBRARY_IMPL(endodepth, CUDA, m) {
  m.impl("fused_dense_conv", &fused_dense_conv_cuda);
}
#endif
