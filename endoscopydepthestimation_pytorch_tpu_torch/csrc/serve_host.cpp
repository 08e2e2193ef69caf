// serve_host: a serving host with no Python, on libtorch.
//
// Serves a bundle written by serving.DepthPredictor.export_native_bundle():
//
//   model.pt2  the AOTInductor package of colors (B, H, W, 3) float32 ->
//              masked depth (B, H, W, 1) float32
//   meta.txt   key=value input/output specs (platform, shapes, dtypes)
//   ops.so     the op library (csrc/dense_conv_op.cpp): endodepth's
//              fused_dense_conv, which the package calls by name
//
// It dlopens ops.so, loads model.pt2 with torch::inductor's
// AOTIModelPackageLoader and serves it: a timed loop with one-shot file in
// and out, or a double-buffered stream of raw batches on stdin and stdout.
// Nothing is built or compiled when a bundle loads. The deployment-side
// dependency surface is this binary, libtorch and the bundle.
//
// Usage:
//   serve_host --bundle <dir> [--device cuda|cpu] [--iters 20] [--warmup 3]
//              [--input raw.bin] [--output depth.bin] [--stream] [--parse-only]
//
// On the card the model runs on a stream of its own, which is current while
// it runs (so the op library's kernel launches on it too) and is handed to
// the loader; the timed loop reads CUDA events recorded on that stream.
#include <dlfcn.h>

#include <ATen/ATen.h>
#include <c10/core/Event.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <optional>
#include <sstream>
#include <string>
#include <vector>

#ifdef ENDODEPTH_CUDA
// CUDAStream.h only: the host calls the CUDA runtime through libc10_cuda
// (streams, and c10::Event and c10::Stream's virtual guard), never itself
#include <c10/cuda/CUDAStream.h>
#endif

namespace {

void die(const std::string& msg) {
  fprintf(stderr, "serve_host: %s\n", msg.c_str());
  exit(1);
}

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) die("cannot read " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

struct TensorSpec {
  std::vector<int64_t> dims;
  std::string dtype;
  size_t bytes() const {
    if (dtype != "float32") die("unsupported dtype " + dtype + " (float32 only)");
    size_t n = 4;
    for (int64_t d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

// meta.txt: key=value lines; inputN_shape=1,256,320,3 / inputN_dtype=float32
struct Meta {
  std::string platform;
  std::vector<TensorSpec> inputs, outputs;
};

Meta parse_meta(const std::string& text) {
  std::map<std::string, std::string> kv;
  std::istringstream ss(text);
  std::string line;
  while (std::getline(ss, line)) {
    size_t eq = line.find('=');
    if (eq != std::string::npos) kv[line.substr(0, eq)] = line.substr(eq + 1);
  }
  Meta meta;
  meta.platform = kv.count("platform") ? kv["platform"] : "?";
  for (const char* kind : {"input", "output"}) {
    auto& list = strcmp(kind, "input") == 0 ? meta.inputs : meta.outputs;
    for (int i = 0;; ++i) {
      std::string base = std::string(kind) + std::to_string(i);
      auto shape_it = kv.find(base + "_shape");
      if (shape_it == kv.end()) break;
      TensorSpec spec;
      std::istringstream dims(shape_it->second);
      std::string d;
      while (std::getline(dims, d, ','))
        if (!d.empty()) spec.dims.push_back(strtoll(d.c_str(), nullptr, 10));
      spec.dtype = kv.count(base + "_dtype") ? kv[base + "_dtype"] : "float32";
      list.push_back(spec);
    }
  }
  if (meta.inputs.size() != 1 || meta.outputs.size() != 1)
    die("meta.txt must list one input and one output");
  return meta;
}

double now_ms() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

at::Tensor from_host(const std::string& bytes, const TensorSpec& spec,
                     const c10::Device& device) {
  at::Tensor host = at::from_blob(const_cast<char*>(bytes.data()), spec.dims, at::kFloat);
  return host.to(at::TensorOptions(device).dtype(at::kFloat), /*non_blocking=*/false,
                 /*copy=*/true);
}

void write_host(const at::Tensor& out, const TensorSpec& spec, FILE* f) {
  at::Tensor host = out.to(at::kCPU).contiguous();
  if (static_cast<size_t>(host.nbytes()) != spec.bytes())
    die("output has " + std::to_string(host.nbytes()) + " bytes, meta.txt says " +
        std::to_string(spec.bytes()));
  if (fwrite(host.data_ptr(), 1, host.nbytes(), f) != host.nbytes())
    die("cannot write the output");
}

}  // namespace

int main(int argc, char** argv) {
  std::string bundle_dir, input_path, output_path, device_name = "cuda";
  int iters = 20, warmup = 3;
  bool stream_mode = false, parse_only = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (++i >= argc) die("missing value for " + a);
      return argv[i];
    };
    if (a == "--bundle") bundle_dir = next();
    else if (a == "--device") device_name = next();
    else if (a == "--input") input_path = next();
    else if (a == "--output") output_path = next();
    else if (a == "--stream") stream_mode = true;
    else if (a == "--parse-only") parse_only = true;
    else if (a == "--iters") iters = atoi(next().c_str());
    else if (a == "--warmup") warmup = atoi(next().c_str());
    else if (a == "--help" || a == "-h") {
      printf("usage: serve_host --bundle <dir> [--device cuda|cpu] [--iters N] "
             "[--warmup K] [--input raw.bin] [--output out.bin] [--stream] "
             "[--parse-only]\n");
      return 0;
    } else {
      die("unknown arg " + a);
    }
  }
  if (bundle_dir.empty()) die("--bundle is required (see --help)");
  if (device_name != "cuda" && device_name != "cpu")
    die("--device must be cuda or cpu, got " + device_name);
  if (iters < 1 || warmup < 0) die("--iters must be >= 1 and --warmup >= 0");

  Meta meta = parse_meta(read_file(bundle_dir + "/meta.txt"));
  const std::string package = bundle_dir + "/model.pt2";
  const std::string ops_path = bundle_dir + "/ops.so";
  if (parse_only) {
    // the bundle contract without a model load: files readable, the
    // package's zip magic, the op library present, specs parsed and sized
    const std::string module = read_file(package);
    if (module.size() < 4 || module.compare(0, 4, "PK\x03\x04", 4) != 0)
      die("model.pt2 lacks the zip magic");
    if (read_file(ops_path).empty()) die("ops.so is empty");
    printf("{\"platform\": \"%s\", \"inputs\": %zu, \"outputs\": %zu, "
           "\"input0_bytes\": %zu, \"output0_bytes\": %zu, "
           "\"module_bytes\": %zu}\n",
           meta.platform.c_str(), meta.inputs.size(), meta.outputs.size(),
           meta.inputs[0].bytes(), meta.outputs[0].bytes(), module.size());
    return 0;
  }

#ifdef ENDODEPTH_CUDA
  if (device_name == "cuda" && !at::hasCUDA()) die("--device cuda: no CUDA device");
#else
  if (device_name == "cuda") die("--device cuda: this host was built without CUDA");
#endif
  if (meta.platform != device_name)
    die("the bundle was compiled for " + meta.platform + ", not " + device_name);
  const c10::Device device = device_name == "cuda" ? c10::Device(c10::kCUDA, 0)
                                                   : c10::Device(c10::kCPU);

  void* ops = dlopen(ops_path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!ops) die(std::string("dlopen: ") + dlerror());
  auto launches = reinterpret_cast<int64_t (*)()>(
      dlsym(ops, "endodepth_dense_conv_launches"));
  if (!launches) die(std::string("endodepth_dense_conv_launches: ") + dlerror());

  // the model's stream on the card: current while it runs (the op library
  // launches on the current stream), handed to the loader, and timed
  std::optional<c10::Stream> stream;
  void* stream_handle = nullptr;
#ifdef ENDODEPTH_CUDA
  if (device.is_cuda()) {
    c10::cuda::CUDAStream cuda_stream =
        c10::cuda::getStreamFromPool(/*isHighPriority=*/false, 0);
    c10::cuda::setCurrentCUDAStream(cuda_stream);  // for the rest of main
    stream = cuda_stream.unwrap();
    stream_handle = cuda_stream.stream();
  }
#endif

  double t_load = now_ms();
  torch::inductor::AOTIModelPackageLoader loader(package, "model", false, 1,
                                                 device.is_cuda() ? 0 : -1);
  double load_ms = now_ms() - t_load;
  const TensorSpec& in0 = meta.inputs[0];
  const TensorSpec& out0 = meta.outputs[0];

  auto run_once = [&](const at::Tensor& input) {
    std::vector<at::Tensor> outputs = loader.run({input}, stream_handle);
    if (outputs.size() != 1) die("the package returned " +
                                 std::to_string(outputs.size()) + " outputs");
    return outputs[0];
  };
  const int64_t k1_before = launches();

  if (stream_mode) {
    // Video-pipeline serving: consecutive input0-sized raw batches on
    // stdin, output0 batches on stdout; batch t is enqueued before batch
    // t-1 is read back and written (the native twin of
    // serving.DepthPredictor.stream). Stats go to stderr.
    std::string in_host(in0.bytes(), '\0');
    std::optional<at::Tensor> pending;
    size_t batches = 0;
    double t0 = now_ms(), first_ms = 0.0;
    for (;;) {
      size_t got = fread(in_host.data(), 1, in_host.size(), stdin);
      if (got == 0) break;
      if (got != in_host.size())
        die("stream: partial input batch (" + std::to_string(got) + " of " +
            std::to_string(in_host.size()) + " bytes)");
      at::Tensor out = run_once(from_host(in_host, in0, device));
      if (pending) {
        write_host(*pending, out0, stdout);
        fflush(stdout);
      }
      pending = out;
      if (++batches == 1) first_ms = now_ms() - t0;  // with the model's lazy set-up
    }
    if (pending) {
      write_host(*pending, out0, stdout);
      fflush(stdout);
    }
    double total_ms = now_ms() - t0;
    fprintf(stderr,
            "{\"metric\": \"serve_host_stream\", \"batches\": %zu, "
            "\"total_ms\": %.4f, \"ms_per_batch\": %.4f, \"first_batch_ms\": %.4f, "
            "\"ms_per_batch_after_first\": %.4f, \"load_ms\": %.1f, "
            "\"k1_launches\": %lld}\n",
            batches, total_ms, batches ? total_ms / batches : 0.0, first_ms,
            batches > 1 ? (total_ms - first_ms) / (batches - 1) : 0.0, load_ms,
            static_cast<long long>(launches() - k1_before));
    return 0;
  }

  std::string in_host(in0.bytes(), '\0');
  if (!input_path.empty()) {
    in_host = read_file(input_path);
    if (in_host.size() != in0.bytes())
      die("--input size " + std::to_string(in_host.size()) + " != expected " +
          std::to_string(in0.bytes()));
  }
  at::Tensor input = from_host(in_host, in0, device);
  at::Tensor out;
  for (int i = 0; i < warmup; ++i) out = run_once(input);
  if (stream) stream->synchronize();

  double per_iter;
  if (stream) {
    c10::Event start(c10::kCUDA, c10::EventFlag::BACKEND_DEFAULT);
    c10::Event end(c10::kCUDA, c10::EventFlag::BACKEND_DEFAULT);
    start.record(*stream);
    for (int i = 0; i < iters; ++i) out = run_once(input);
    end.record(*stream);
    end.synchronize();
    per_iter = start.elapsedTime(end) / iters;
  } else {
    double t0 = now_ms();
    for (int i = 0; i < iters; ++i) out = run_once(input);
    per_iter = (now_ms() - t0) / iters;
  }
  const int64_t k1 = launches() - k1_before;

  if (!output_path.empty()) {
    FILE* f = fopen(output_path.c_str(), "wb");
    if (!f) die("cannot write " + output_path);
    write_host(out, out0, f);
    if (fclose(f) != 0) die("cannot write " + output_path);
  }

  int64_t batch = in0.dims.empty() ? 1 : in0.dims[0];
  printf("{\"metric\": \"serve_host_latency\", \"value\": %.4f, \"unit\": "
         "\"ms/batch\", \"batch\": %lld, \"fps\": %.2f, \"iters\": %d, "
         "\"warmup\": %d, \"load_ms\": %.1f, \"device\": \"%s\", "
         "\"k1_launches\": %lld}\n",
         per_iter, static_cast<long long>(batch),
         1000.0 * static_cast<double>(batch) / per_iter, iters, warmup, load_ms,
         device_name.c_str(), static_cast<long long>(k1));
  return 0;
}
