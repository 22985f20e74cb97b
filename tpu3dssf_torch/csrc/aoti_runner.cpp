// aoti_runner: run an AOTInductor package of the port without Python.
//
//   aoti_runner PACKAGE DEVICE INPUT_DIR OUTPUT_DIR CALLS [LIBRARY ...]
//
// The port's counterpart of serving JAX's exported artifact from C++
// through the PJRT C API. In order, it
//   1. loads each LIBRARY (dlopen, global symbols): the tpu3dssf operator
//      libraries that tpu3dssf_torch/kernels/_build.py builds, the schema
//      library first, then on a card the CUDA library, whose kernels the
//      package's tpu3dssf:: ops reach through the dispatcher;
//   2. loads PACKAGE (a .pt2 of tpu3dssf_torch.export.compile_infer_package)
//      with torch::inductor::AOTIModelPackageLoader;
//   3. reads the inputs INPUT_DIR/input_<i>.raw (tpu3dssf_torch.export.
//      write_raw: a text line "tpu3dssf-raw <dtype> <ndim> <sizes...>",
//      then the data) onto DEVICE ("cuda" or "cpu");
//   4. runs the program once and writes its outputs as OUTPUT_DIR/
//      output_<i>.raw, with the launches of that call read from the CUDA
//      library's counters (tpu3dssf_read_launch_counts);
//   5. runs it twice more to warm up, then CALLS times, each call timed on
//      the host's clock up to a synchronisation of the device;
//   6. prints one JSON line: {"outputs": n, "launches_per_call": {"K1": n,
//      ..., "LN": n}, "call_ms": [...], "median_ms": m}, a kernel with no
//      launch left out.
// It includes no CUDA header, and links libtorch but not libpython.

#include <ATen/ATen.h>
#include <dlfcn.h>
#include <torch/cuda.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <fstream>
#include <iterator>
#include <map>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// the CUDA library's counters, in its order (ops_cuda.cpp's kCounters)
constexpr const char* kCounters[] = {"K1", "K2", "K3", "K4", "K5", "K6",
                                     "K7", "K8", "K9", "LN", "LNB"};
constexpr int kKernels = sizeof(kCounters) / sizeof(kCounters[0]);
using ReadCounts = void (*)(int64_t*);

const std::map<std::string, at::ScalarType>& dtypes() {
  static const std::map<std::string, at::ScalarType> m = {
      {"float32", at::kFloat}, {"float64", at::kDouble},
      {"float16", at::kHalf},  {"bfloat16", at::kBFloat16},
      {"int64", at::kLong},    {"int32", at::kInt},
      {"int16", at::kShort},   {"int8", at::kChar},
      {"uint8", at::kByte},    {"bool", at::kBool}};
  return m;
}

std::string dtype_name(at::ScalarType t) {
  for (const auto& [name, type] : dtypes())
    if (type == t) return name;
  throw std::runtime_error("no raw name for dtype " +
                           std::string(c10::toString(t)));
}

at::Tensor read_raw(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::string line;
  std::getline(f, line);
  std::istringstream header(line);
  std::string magic, name;
  int64_t ndim = 0;
  header >> magic >> name >> ndim;
  if (magic != "tpu3dssf-raw" || !dtypes().count(name))
    throw std::runtime_error(path + ": not a raw tensor file");
  std::vector<int64_t> sizes(ndim);
  for (auto& n : sizes) header >> n;
  at::Tensor x = at::empty(sizes, at::TensorOptions().dtype(dtypes().at(name)));
  f.read(static_cast<char*>(x.data_ptr()), x.nbytes());
  if (static_cast<size_t>(f.gcount()) != x.nbytes())
    throw std::runtime_error(path + ": short data");
  return x;
}

void write_raw(const std::string& path, const at::Tensor& t) {
  at::Tensor x = t.detach().cpu().contiguous();
  std::ofstream f(path, std::ios::binary);
  f << "tpu3dssf-raw " << dtype_name(x.scalar_type()) << " " << x.dim();
  for (int64_t n : x.sizes()) f << " " << n;
  f << "\n";
  f.write(static_cast<const char*>(x.data_ptr()), x.nbytes());
  if (!f) throw std::runtime_error("cannot write " + path);
}

bool exists(const std::string& path) { return std::ifstream(path).good(); }

void sync(const c10::Device& device) {
  if (device.is_cuda()) torch::cuda::synchronize();
}

std::vector<int64_t> counts(ReadCounts read) {
  std::vector<int64_t> c(kKernels, 0);
  if (read) read(c.data());
  return c;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 6) {
    std::fprintf(stderr,
                 "usage: %s PACKAGE DEVICE INPUT_DIR OUTPUT_DIR CALLS "
                 "[LIBRARY ...]\n",
                 argv[0]);
    return 2;
  }
  const std::string package = argv[1], in_dir = argv[3], out_dir = argv[4];
  const c10::Device device(argv[2]);
  const int calls = std::stoi(argv[5]);
  try {
    ReadCounts read = nullptr;
    for (int i = 6; i < argc; ++i) {
      void* lib = dlopen(argv[i], RTLD_NOW | RTLD_GLOBAL);
      if (!lib) throw std::runtime_error(dlerror());
      if (auto fn = dlsym(lib, "tpu3dssf_read_launch_counts"))
        read = reinterpret_cast<ReadCounts>(fn);
    }
    torch::inductor::AOTIModelPackageLoader loader(package);
    std::vector<at::Tensor> inputs;
    for (int i = 0;; ++i) {
      const std::string path = in_dir + "/input_" + std::to_string(i) + ".raw";
      if (!exists(path)) break;
      inputs.push_back(read_raw(path).to(device));
    }
    c10::InferenceMode guard;
    const auto before = counts(read);
    std::vector<at::Tensor> outputs = loader.run(inputs);
    sync(device);
    const auto after = counts(read);
    for (size_t i = 0; i < outputs.size(); ++i)
      write_raw(out_dir + "/output_" + std::to_string(i) + ".raw", outputs[i]);
    for (int i = 0; i < 2; ++i) loader.run(inputs);
    sync(device);
    std::vector<double> ms;
    for (int i = 0; i < calls; ++i) {
      const auto t0 = std::chrono::steady_clock::now();
      loader.run(inputs);
      sync(device);
      ms.push_back(std::chrono::duration<double, std::milli>(
                       std::chrono::steady_clock::now() - t0)
                       .count());
    }
    std::vector<double> sorted = ms;
    std::sort(sorted.begin(), sorted.end());
    const double median =
        sorted.empty() ? 0.0
                       : (sorted.size() % 2
                              ? sorted[sorted.size() / 2]
                              : (sorted[sorted.size() / 2 - 1] +
                                 sorted[sorted.size() / 2]) / 2);
    std::printf("{\"outputs\": %zu, \"launches_per_call\": {", outputs.size());
    bool first = true;
    for (int k = 0; k < kKernels; ++k) {
      if (after[k] == before[k]) continue;
      std::printf("%s\"%s\": %lld", first ? "" : ", ", kCounters[k],
                  static_cast<long long>(after[k] - before[k]));
      first = false;
    }
    std::printf("}, \"call_ms\": [");
    for (size_t i = 0; i < ms.size(); ++i)
      std::printf("%s%.6f", i ? ", " : "", ms[i]);
    std::printf("], \"median_ms\": %.6f}\n", median);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_runner: %s\n", e.what());
    return 1;
  }
  return 0;
}
