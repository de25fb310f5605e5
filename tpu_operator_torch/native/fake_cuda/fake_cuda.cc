// fake_cuda — a test-only stand-in for libcuda.so.1 (libfake-cuda.so), so
// that `gpu-smoke --run-add` can be driven through the real driver-API
// call sequence on a machine without a card. It exports exactly the
// symbols the runner resolves. Its "device" is host memory: cuMemAlloc_v2
// hands out heap blocks, and launching the function that the loaded PTX
// names runs the elementwise add over the threads the grid covers.
//
// Planted faults, by environment:
//   FAKE_CUDA_FAIL=<symbol>[=<code>]  that call returns <code> (default
//                                     999, CUDA_ERROR_UNKNOWN)
//   FAKE_CUDA_DEVICES=<n>             cuDeviceGetCount answers n (default 1)
//   FAKE_CUDA_CORRUPT=<i>             the kernel gets element i wrong
//
// At exit it reports on stderr what the runner did not release (device
// memory, modules, the primary context).
//
// The card path never loads this library.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <set>
#include <string>

namespace {

using CUresult = int;
using CUdeviceptr = unsigned long long;

constexpr CUresult kSuccess = 0;
constexpr CUresult kInvalidValue = 1;
constexpr CUresult kNotInitialized = 3;
constexpr CUresult kInvalidContext = 201;
constexpr CUresult kInvalidPtx = 218;
constexpr CUresult kNotFound = 500;
constexpr CUresult kUnknown = 999;

bool g_init = false;
int g_retained = 0;
int g_ctx_token = 0;  // the primary context's handle points here
void* g_current = nullptr;
std::set<CUdeviceptr> g_blocks;
int g_modules = 0;

struct Module {
  std::string entry;  // the .entry the PTX declares
};

// The code a planted fault gives `symbol`, or kSuccess.
CUresult Planted(const char* symbol) {
  const char* spec = getenv("FAKE_CUDA_FAIL");
  if (spec == nullptr) return kSuccess;
  std::string s = spec;
  std::string name = s.substr(0, s.find('='));
  if (name != symbol) return kSuccess;
  if (s.find('=') == std::string::npos) return kUnknown;
  return static_cast<CUresult>(std::atoi(s.c_str() + s.find('=') + 1));
}

#define FAKE_PLANTED(symbol)                  \
  do {                                        \
    CUresult _rc = Planted(symbol);           \
    if (_rc != kSuccess) return _rc;          \
  } while (0)

bool Ready() { return g_init && g_current != nullptr; }

bool Owned(CUdeviceptr p, size_t bytes) {
  for (CUdeviceptr b : g_blocks) {
    // blocks remember their size in the word before them
    size_t size = reinterpret_cast<size_t*>(b)[-1];
    if (p >= b && p + bytes <= b + size) return true;
  }
  return false;
}

}  // namespace

extern "C" {

CUresult cuInit(unsigned flags) {
  FAKE_PLANTED("cuInit");
  if (flags != 0) return kInvalidValue;
  g_init = true;
  return kSuccess;
}

CUresult cuDriverGetVersion(int* v) {
  FAKE_PLANTED("cuDriverGetVersion");
  *v = 12080;
  return kSuccess;
}

CUresult cuDeviceGetCount(int* n) {
  FAKE_PLANTED("cuDeviceGetCount");
  if (!g_init) return kNotInitialized;
  const char* env = getenv("FAKE_CUDA_DEVICES");
  *n = env != nullptr ? std::atoi(env) : 1;
  return kSuccess;
}

CUresult cuDeviceGet(int* dev, int ordinal) {
  FAKE_PLANTED("cuDeviceGet");
  if (!g_init) return kNotInitialized;
  if (ordinal != 0) return kInvalidValue;
  *dev = 0;
  return kSuccess;
}

CUresult cuDeviceGetName(char* name, int len, int dev) {
  FAKE_PLANTED("cuDeviceGetName");
  if (dev != 0 || len <= 0) return kInvalidValue;
  std::strncpy(name, "Fake CUDA Device", static_cast<size_t>(len));
  name[len - 1] = '\0';
  return kSuccess;
}

CUresult cuDeviceGetAttribute(int* v, int attr, int dev) {
  FAKE_PLANTED("cuDeviceGetAttribute");
  if (dev != 0) return kInvalidValue;
  if (attr == 75) *v = 9;        // compute capability major
  else if (attr == 76) *v = 0;   // minor
  else return kInvalidValue;
  return kSuccess;
}

CUresult cuDevicePrimaryCtxRetain(void** ctx, int dev) {
  FAKE_PLANTED("cuDevicePrimaryCtxRetain");
  if (!g_init) return kNotInitialized;
  if (dev != 0) return kInvalidValue;
  ++g_retained;
  *ctx = &g_ctx_token;
  return kSuccess;
}

CUresult cuDevicePrimaryCtxRelease_v2(int dev) {
  FAKE_PLANTED("cuDevicePrimaryCtxRelease_v2");
  if (dev != 0 || g_retained == 0) return kInvalidContext;
  if (--g_retained == 0) g_current = nullptr;
  return kSuccess;
}

CUresult cuCtxSetCurrent(void* ctx) {
  FAKE_PLANTED("cuCtxSetCurrent");
  if (ctx != &g_ctx_token || g_retained == 0) return kInvalidContext;
  g_current = ctx;
  return kSuccess;
}

CUresult cuModuleLoadDataEx(void** module, const void* image, unsigned n,
                            int* options, void** values) {
  CUresult rc = Planted("cuModuleLoadDataEx");
  std::string ptx = static_cast<const char*>(image);
  std::string entry;
  size_t e = ptx.find(".entry ");
  if (e != std::string::npos) {
    size_t start = e + 7;
    entry = ptx.substr(start, ptx.find('(', start) - start);
  }
  if (rc == kSuccess && !Ready()) rc = kInvalidContext;
  if (rc == kSuccess && entry.empty()) rc = kInvalidPtx;
  // answer the JIT options as the driver does: logs into the buffers
  char* info = nullptr;
  char* error = nullptr;
  size_t infoSize = 0, errorSize = 0;
  for (unsigned i = 0; i < n; ++i) {
    uintptr_t v = reinterpret_cast<uintptr_t>(values[i]);
    if (options[i] == 3) {
      info = static_cast<char*>(values[i]);
    } else if (options[i] == 4) {
      infoSize = v;
    } else if (options[i] == 5) {
      error = static_cast<char*>(values[i]);
    } else if (options[i] == 6) {
      errorSize = v;
    }
  }
  auto put = [](char* buf, size_t size, const std::string& text) {
    if (buf == nullptr || size == 0) return;
    std::strncpy(buf, text.c_str(), size);
    buf[size - 1] = '\0';
  };
  if (rc != kSuccess) {
    put(error, errorSize, "fake ptxas: planted failure");
    return rc;
  }
  put(info, infoSize, "fake ptxas info: Compiling entry function '" +
                          entry + "' for 'sm_90'");
  *module = new Module{entry};
  ++g_modules;
  return kSuccess;
}

CUresult cuModuleUnload(void* module) {
  FAKE_PLANTED("cuModuleUnload");
  delete static_cast<Module*>(module);
  --g_modules;
  return kSuccess;
}

CUresult cuModuleGetFunction(void** fn, void* module, const char* name) {
  FAKE_PLANTED("cuModuleGetFunction");
  if (module == nullptr) return kInvalidValue;
  if (static_cast<Module*>(module)->entry != name) return kNotFound;
  *fn = module;  // a module holds one function
  return kSuccess;
}

CUresult cuMemAlloc_v2(CUdeviceptr* p, size_t bytes) {
  FAKE_PLANTED("cuMemAlloc_v2");
  if (!Ready()) return kInvalidContext;
  if (bytes == 0) return kInvalidValue;
  auto* block = static_cast<size_t*>(std::malloc(bytes + sizeof(size_t)));
  if (block == nullptr) return 2;  // out of memory
  block[0] = bytes;
  *p = reinterpret_cast<CUdeviceptr>(block + 1);
  g_blocks.insert(*p);
  return kSuccess;
}

CUresult cuMemFree_v2(CUdeviceptr p) {
  FAKE_PLANTED("cuMemFree_v2");
  if (g_blocks.erase(p) == 0) return kInvalidValue;
  std::free(reinterpret_cast<size_t*>(p) - 1);
  return kSuccess;
}

CUresult cuMemcpyHtoD_v2(CUdeviceptr dst, const void* src, size_t bytes) {
  FAKE_PLANTED("cuMemcpyHtoD_v2");
  if (!Ready()) return kInvalidContext;
  if (!Owned(dst, bytes)) return kInvalidValue;
  std::memcpy(reinterpret_cast<void*>(dst), src, bytes);
  return kSuccess;
}

CUresult cuMemcpyDtoH_v2(void* dst, CUdeviceptr src, size_t bytes) {
  FAKE_PLANTED("cuMemcpyDtoH_v2");
  if (!Ready()) return kInvalidContext;
  if (!Owned(src, bytes)) return kInvalidValue;
  std::memcpy(dst, reinterpret_cast<void*>(src), bytes);
  return kSuccess;
}

// The add the PTX's kernel computes, for every thread the launch covers.
CUresult cuLaunchKernel(void* fn, unsigned gx, unsigned gy, unsigned gz,
                        unsigned bx, unsigned by, unsigned bz,
                        unsigned shared, void* stream, void** params,
                        void** extra) {
  FAKE_PLANTED("cuLaunchKernel");
  if (!Ready()) return kInvalidContext;
  if (fn == nullptr || params == nullptr || extra != nullptr ||
      stream != nullptr || shared != 0 || gy != 1 || gz != 1 || by != 1 ||
      bz != 1 || bx == 0 || bx > 1024) {
    return kInvalidValue;
  }
  CUdeviceptr a = *static_cast<CUdeviceptr*>(params[0]);
  CUdeviceptr b = *static_cast<CUdeviceptr*>(params[1]);
  CUdeviceptr c = *static_cast<CUdeviceptr*>(params[2]);
  unsigned n = *static_cast<unsigned*>(params[3]);
  size_t bytes = static_cast<size_t>(n) * sizeof(float);
  if (!Owned(a, bytes) || !Owned(b, bytes) || !Owned(c, bytes)) {
    return 700;  // an illegal address, as the card reports it
  }
  unsigned long long threads = static_cast<unsigned long long>(gx) * bx;
  for (unsigned long long i = 0; i < threads && i < n; ++i) {
    reinterpret_cast<float*>(c)[i] =
        reinterpret_cast<float*>(a)[i] + reinterpret_cast<float*>(b)[i];
  }
  if (const char* bad = getenv("FAKE_CUDA_CORRUPT")) {
    unsigned long long i = std::strtoull(bad, nullptr, 10);
    if (i < n) reinterpret_cast<float*>(c)[i] += 1.0f;
  }
  return kSuccess;
}

CUresult cuCtxSynchronize() {
  FAKE_PLANTED("cuCtxSynchronize");
  return Ready() ? kSuccess : kInvalidContext;
}

CUresult cuGetErrorName(CUresult rc, const char** name) {
  switch (rc) {
    case kSuccess: *name = "CUDA_SUCCESS"; break;
    case kInvalidValue: *name = "CUDA_ERROR_INVALID_VALUE"; break;
    case 2: *name = "CUDA_ERROR_OUT_OF_MEMORY"; break;
    case kNotInitialized: *name = "CUDA_ERROR_NOT_INITIALIZED"; break;
    case kInvalidContext: *name = "CUDA_ERROR_INVALID_CONTEXT"; break;
    case kInvalidPtx: *name = "CUDA_ERROR_INVALID_PTX"; break;
    case kNotFound: *name = "CUDA_ERROR_NOT_FOUND"; break;
    case 700: *name = "CUDA_ERROR_ILLEGAL_ADDRESS"; break;
    case kUnknown: *name = "CUDA_ERROR_UNKNOWN"; break;
    default: *name = nullptr; return kInvalidValue;
  }
  return kSuccess;
}

CUresult cuGetErrorString(CUresult rc, const char** text) {
  const char* name = nullptr;
  if (cuGetErrorName(rc, &name) != kSuccess) return kInvalidValue;
  *text = "planted by the fake driver";
  return kSuccess;
}

}  // extern "C"

namespace {

__attribute__((destructor)) void ReportLeaks() {
  if (!g_blocks.empty() || g_modules != 0 || g_retained != 0) {
    std::fprintf(stderr,
                 "fake-cuda: leaked %zu allocation(s), %d module(s), %d "
                 "primary context reference(s)\n",
                 g_blocks.size(), g_modules, g_retained);
  }
}

}  // namespace
