// An elementwise add launched through the CUDA driver API (the vectorAdd
// analogue of the reference validator).
#pragma once

#include <string>

namespace gpuop {

struct CudaAddResult {
  bool ok = false;
  int n = 0;
  int devices = 0;
  int driverVersion = 0;  // cuDriverGetVersion: 1000 * major + 10 * minor
  std::string device;     // cuDeviceGetName of device 0
  int ccMajor = 0, ccMinor = 0;
  // host-clock milliseconds of each stage
  double initMs = 0, jitMs = 0, addMs = 0;
  std::string jitLog;  // the JIT's info log
  std::string error;   // which step failed (empty on success)
  std::string detail;  // the driver's name and text for the error
};

// dlopen `libcudaPath` (verbatim, no search), resolve the driver API by
// dlsym (the versioned _v2 symbols where the API has them), create the
// primary context of device 0, JIT the PTX, launch c = a + b over `n`
// floats, copy back and check every element exactly against the host's
// f32 add. Returns result->ok.
bool RunCudaAdd(const std::string& libcudaPath, int n, CudaAddResult* result);

}  // namespace gpuop
