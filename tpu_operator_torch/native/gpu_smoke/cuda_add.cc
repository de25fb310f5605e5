// cuda_add — an elementwise add on the card through the CUDA driver API:
// the native analogue of the reference validator's `vectorAdd`. Where the
// TPU smoke compiles StableHLO through the PJRT C API, this JITs a PTX
// kernel: dlopen libcuda.so.1 → cuInit → primary context → load PTX →
// launch → copy back → check a[i] + b[i] exactly.
//
// No CUDA header is used. The prototypes are declared by hand from the
// driver API reference. Where the API has versioned symbols (cuMemAlloc_v2
// and the copies), the versioned one is resolved: the unsuffixed
// cuMemAlloc is the legacy ABI with 32-bit sizes and device pointers.

#include "cuda_add.h"

#include <dlfcn.h>

#include <chrono>
#include <cstdint>
#include <cstring>
#include <sstream>
#include <vector>

namespace gpuop {

const char kAddKernelName[] = "vector_add";

// c[i] = a[i] + b[i] for i < n; one thread an element. `add.f32` rounds to
// nearest even, as the host's f32 add does, so the check is exact.
const char kAddPtx[] = R"PTX(
.version 6.4
.target sm_52
.address_size 64

.visible .entry vector_add(
    .param .u64 vector_add_param_0,
    .param .u64 vector_add_param_1,
    .param .u64 vector_add_param_2,
    .param .u32 vector_add_param_3
)
{
    .reg .pred %p<2>;
    .reg .b32 %r<6>;
    .reg .f32 %f<4>;
    .reg .b64 %rd<11>;

    ld.param.u64 %rd1, [vector_add_param_0];
    ld.param.u64 %rd2, [vector_add_param_1];
    ld.param.u64 %rd3, [vector_add_param_2];
    ld.param.u32 %r1, [vector_add_param_3];
    mov.u32 %r2, %ctaid.x;
    mov.u32 %r3, %ntid.x;
    mov.u32 %r4, %tid.x;
    mad.lo.s32 %r5, %r2, %r3, %r4;
    setp.ge.u32 %p1, %r5, %r1;
    @%p1 bra $L__done;
    cvta.to.global.u64 %rd4, %rd1;
    cvta.to.global.u64 %rd5, %rd2;
    cvta.to.global.u64 %rd6, %rd3;
    mul.wide.u32 %rd7, %r5, 4;
    add.s64 %rd8, %rd4, %rd7;
    add.s64 %rd9, %rd5, %rd7;
    add.s64 %rd10, %rd6, %rd7;
    ld.global.f32 %f1, [%rd8];
    ld.global.f32 %f2, [%rd9];
    add.rn.f32 %f3, %f1, %f2;
    st.global.f32 [%rd10], %f3;
$L__done:
    ret;
}
)PTX";

namespace {

using CUresult = int;
using CUdevice = int;
using CUdeviceptr = unsigned long long;
using CUcontext = void*;
using CUmodule = void*;
using CUfunction = void*;
using CUstream = void*;

// CUjit_option and CUdevice_attribute values used here
constexpr int kJitInfoLogBuffer = 3;
constexpr int kJitInfoLogBufferSize = 4;
constexpr int kJitErrorLogBuffer = 5;
constexpr int kJitErrorLogBufferSize = 6;
constexpr int kJitLogVerbose = 12;
constexpr int kAttrComputeCapabilityMajor = 75;
constexpr int kAttrComputeCapabilityMinor = 76;
constexpr int kBlock = 256;

struct Api {
  CUresult (*cuInit)(unsigned);
  CUresult (*cuDriverGetVersion)(int*);
  CUresult (*cuDeviceGetCount)(int*);
  CUresult (*cuDeviceGet)(CUdevice*, int);
  CUresult (*cuDeviceGetName)(char*, int, CUdevice);
  CUresult (*cuDeviceGetAttribute)(int*, int, CUdevice);
  CUresult (*cuDevicePrimaryCtxRetain)(CUcontext*, CUdevice);
  CUresult (*cuDevicePrimaryCtxRelease_v2)(CUdevice);
  CUresult (*cuCtxSetCurrent)(CUcontext);
  CUresult (*cuModuleLoadDataEx)(CUmodule*, const void*, unsigned, int*,
                                 void**);
  CUresult (*cuModuleUnload)(CUmodule);
  CUresult (*cuModuleGetFunction)(CUfunction*, CUmodule, const char*);
  CUresult (*cuMemAlloc_v2)(CUdeviceptr*, size_t);
  CUresult (*cuMemFree_v2)(CUdeviceptr);
  CUresult (*cuMemcpyHtoD_v2)(CUdeviceptr, const void*, size_t);
  CUresult (*cuMemcpyDtoH_v2)(void*, CUdeviceptr, size_t);
  CUresult (*cuLaunchKernel)(CUfunction, unsigned, unsigned, unsigned,
                             unsigned, unsigned, unsigned, unsigned, CUstream,
                             void**, void**);
  CUresult (*cuCtxSynchronize)();
  CUresult (*cuGetErrorName)(CUresult, const char**);
  CUresult (*cuGetErrorString)(CUresult, const char**);
};

double Ms(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

// What the driver says about `rc`: "CUDA_ERROR_X (text)", or the number
// where the library cannot name it.
std::string Describe(const Api& api, CUresult rc) {
  std::ostringstream os;
  const char* name = nullptr;
  const char* text = nullptr;
  if (api.cuGetErrorName == nullptr || api.cuGetErrorName(rc, &name) != 0 ||
      name == nullptr) {
    os << "CUresult " << rc;
    return os.str();
  }
  os << name;
  if (api.cuGetErrorString != nullptr && api.cuGetErrorString(rc, &text) == 0 &&
      text != nullptr) {
    os << " (" << text << ")";
  }
  return os.str();
}

// Releases what a run acquired, on every exit path.
struct Session {
  const Api* api = nullptr;
  bool ctx = false;
  CUdevice dev = 0;
  CUmodule module = nullptr;
  std::vector<CUdeviceptr> buffers;
  ~Session() {
    if (api != nullptr) {
      for (CUdeviceptr p : buffers) api->cuMemFree_v2(p);
      if (module != nullptr) api->cuModuleUnload(module);
      if (ctx) api->cuDevicePrimaryCtxRelease_v2(dev);
    }
    // the library stays mapped: a driver's threads may outlive the context
  }
};

}  // namespace

bool RunCudaAdd(const std::string& libcudaPath, int n, CudaAddResult* result) {
  result->n = n;
  auto t0 = std::chrono::steady_clock::now();
  void* h = dlopen(libcudaPath.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (h == nullptr) {
    const char* err = dlerror();  // read once: dlerror() clears its state
    result->error = "dlopen";
    result->detail = err != nullptr ? err : libcudaPath;
    return false;
  }
  Api api{};
#define GPUOP_BIND(fn)                                           \
  api.fn = reinterpret_cast<decltype(api.fn)>(dlsym(h, #fn));    \
  if (api.fn == nullptr) {                                       \
    result->error = "dlsym(" #fn ")";                            \
    result->detail = "the library does not export " #fn;         \
    return false;                                                \
  }
  GPUOP_BIND(cuInit)
  GPUOP_BIND(cuDriverGetVersion)
  GPUOP_BIND(cuDeviceGetCount)
  GPUOP_BIND(cuDeviceGet)
  GPUOP_BIND(cuDeviceGetName)
  GPUOP_BIND(cuDeviceGetAttribute)
  GPUOP_BIND(cuDevicePrimaryCtxRetain)
  GPUOP_BIND(cuDevicePrimaryCtxRelease_v2)
  GPUOP_BIND(cuCtxSetCurrent)
  GPUOP_BIND(cuModuleLoadDataEx)
  GPUOP_BIND(cuModuleUnload)
  GPUOP_BIND(cuModuleGetFunction)
  GPUOP_BIND(cuMemAlloc_v2)
  GPUOP_BIND(cuMemFree_v2)
  GPUOP_BIND(cuMemcpyHtoD_v2)
  GPUOP_BIND(cuMemcpyDtoH_v2)
  GPUOP_BIND(cuLaunchKernel)
  GPUOP_BIND(cuCtxSynchronize)
  GPUOP_BIND(cuGetErrorName)
  GPUOP_BIND(cuGetErrorString)
#undef GPUOP_BIND

  Session s;
  s.api = &api;
// the step that failed is named by its driver-API function
#define GPUOP_CHECK(call)                         \
  do {                                            \
    CUresult _rc = (call);                        \
    if (_rc != 0) {                               \
      std::string step = #call;                   \
      result->error = step.substr(4, step.find('(') - 4); \
      result->detail = Describe(api, _rc);        \
      return false;                               \
    }                                             \
  } while (0)

  GPUOP_CHECK(api.cuInit(0));
  GPUOP_CHECK(api.cuDriverGetVersion(&result->driverVersion));
  GPUOP_CHECK(api.cuDeviceGetCount(&result->devices));
  if (result->devices == 0) {
    result->error = "cuDeviceGetCount";
    result->detail = "no CUDA device";
    return false;
  }
  GPUOP_CHECK(api.cuDeviceGet(&s.dev, 0));
  char name[256] = {0};
  GPUOP_CHECK(api.cuDeviceGetName(name, sizeof(name) - 1, s.dev));
  result->device = name;
  GPUOP_CHECK(api.cuDeviceGetAttribute(&result->ccMajor,
                                       kAttrComputeCapabilityMajor, s.dev));
  GPUOP_CHECK(api.cuDeviceGetAttribute(&result->ccMinor,
                                       kAttrComputeCapabilityMinor, s.dev));
  CUcontext ctx = nullptr;
  GPUOP_CHECK(api.cuDevicePrimaryCtxRetain(&ctx, s.dev));
  s.ctx = true;
  GPUOP_CHECK(api.cuCtxSetCurrent(ctx));
  result->initMs = Ms(t0);

  // the JIT: PTX for sm_52 compiled for the card's own architecture
  std::vector<char> infoLog(8192, '\0'), errorLog(8192, '\0');
  int options[] = {kJitInfoLogBuffer, kJitInfoLogBufferSize,
                   kJitErrorLogBuffer, kJitErrorLogBufferSize,
                   kJitLogVerbose};
  void* values[] = {
      infoLog.data(),
      reinterpret_cast<void*>(static_cast<uintptr_t>(infoLog.size() - 1)),
      errorLog.data(),
      reinterpret_cast<void*>(static_cast<uintptr_t>(errorLog.size() - 1)),
      reinterpret_cast<void*>(static_cast<uintptr_t>(1))};
  auto tj = std::chrono::steady_clock::now();
  CUresult rc = api.cuModuleLoadDataEx(&s.module, kAddPtx,
                                       sizeof(options) / sizeof(options[0]),
                                       options, values);
  result->jitMs = Ms(tj);
  result->jitLog = infoLog.data();
  if (rc != 0) {
    s.module = nullptr;
    result->error = "cuModuleLoadDataEx";
    result->detail = Describe(api, rc) + ": " + errorLog.data();
    return false;
  }
  CUfunction fn = nullptr;
  GPUOP_CHECK(api.cuModuleGetFunction(&fn, s.module, kAddKernelName));

  std::vector<float> a(n), b(n), out(n, -1.0f);
  for (int i = 0; i < n; ++i) {
    a[i] = static_cast<float>(i);
    b[i] = 2.0f * static_cast<float>(i) + 1.0f;
  }
  const size_t bytes = static_cast<size_t>(n) * sizeof(float);
  CUdeviceptr dA = 0, dB = 0, dC = 0;
  GPUOP_CHECK(api.cuMemAlloc_v2(&dA, bytes));
  s.buffers.push_back(dA);
  GPUOP_CHECK(api.cuMemAlloc_v2(&dB, bytes));
  s.buffers.push_back(dB);
  GPUOP_CHECK(api.cuMemAlloc_v2(&dC, bytes));
  s.buffers.push_back(dC);
  GPUOP_CHECK(api.cuMemcpyHtoD_v2(dA, a.data(), bytes));
  GPUOP_CHECK(api.cuMemcpyHtoD_v2(dB, b.data(), bytes));
  unsigned count = static_cast<unsigned>(n);
  void* params[] = {&dA, &dB, &dC, &count};
  unsigned grid = (count + kBlock - 1) / kBlock;
  auto ta = std::chrono::steady_clock::now();
  GPUOP_CHECK(api.cuLaunchKernel(fn, grid, 1, 1, kBlock, 1, 1, 0, nullptr,
                                 params, nullptr));
  GPUOP_CHECK(api.cuCtxSynchronize());
  result->addMs = Ms(ta);
  GPUOP_CHECK(api.cuMemcpyDtoH_v2(out.data(), dC, bytes));
#undef GPUOP_CHECK

  for (int i = 0; i < n; ++i) {
    float want = a[i] + b[i];
    if (std::memcmp(&out[i], &want, sizeof(float)) != 0) {
      std::ostringstream os;
      os << "out[" << i << "] = " << out[i] << ", want " << want;
      result->error = "verify";
      result->detail = os.str();
      return false;
    }
  }
  result->ok = true;
  return true;
}

}  // namespace gpuop
