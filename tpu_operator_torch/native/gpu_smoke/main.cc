// gpu-smoke — the reference validator's CUDA vectorAdd smoke binary, as the
// operator ships it: a cheap startup probe for the driver DaemonSet.
//
// Without --run-add: the card device nodes exist and libcuda.so.1 is
// present, dlopen-able, and exports the driver API (cuInit). The library
// is --libcuda, else DRIVER_INSTALL_DIR's (the driver installer's
// container, where the probe runs), else the one under NVIDIA_DRIVER_ROOT. With
// --run-add: an elementwise add of n floats JIT-compiled from PTX and run
// on device 0 through the driver API, checked exactly on the host.
//
// Output: one JSON line. Exit 0 iff everything checks out, 1 if a check
// failed, 2 on a usage error.

#include <cstdlib>
#include <iostream>
#include <string>
#include <vector>

#include "../common/util.h"
#include "cuda_add.h"

namespace {

// cuDriverGetVersion's 12080 as "12.8"
std::string DriverApiVersion(int v) {
  return std::to_string(v / 1000) + "." + std::to_string((v % 1000) / 10);
}

}  // namespace

int main(int argc, char** argv) {
  std::string devGlob = gpuop::kDefaultDeviceGlob;
  std::string libcudaPath;
  std::string driverRoot = "/";
  if (const char* v = getenv("NVIDIA_DRIVER_ROOT")) driverRoot = v;
  std::string installDir;
  if (const char* v = getenv("DRIVER_INSTALL_DIR")) installDir = v;
  bool quiet = false;
  bool requireDevices = true;
  bool runAdd = false;
  std::string addN = "1024";

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--quiet") {
      quiet = true;
    } else if (a == "--device-glob" && i + 1 < argc) {
      devGlob = argv[++i];
    } else if (a == "--libcuda" && i + 1 < argc) {
      libcudaPath = argv[++i];
    } else if (a == "--no-require-devices") {
      requireDevices = false;
    } else if (a == "--run-add") {
      runAdd = true;
    } else if (a == "--n" && i + 1 < argc) {
      addN = argv[++i];
    } else if (a == "--help" || a == "-h") {
      std::cout << "usage: gpu-smoke [--quiet] [--device-glob G] "
                   "[--libcuda PATH] [--no-require-devices] "
                   "[--run-add [--n N]]\n"
                   "--run-add: JIT a PTX elementwise add and run it on "
                   "device 0 through the CUDA driver API (vectorAdd)\n";
      return 0;
    } else {
      std::cerr << "unknown flag: " << a << "\n";
      return 2;
    }
  }
  // an explicit --libcuda path is honoured verbatim: falling back to
  // system locations would let the startup probe pass after a failed
  // install (the probe exists to catch exactly that)
  std::string lib = !libcudaPath.empty()
                        ? libcudaPath
                        : gpuop::LibcudaPath(installDir, driverRoot);

  if (runAdd) {
    char* end = nullptr;
    long n = std::strtol(addN.c_str(), &end, 10);
    if (addN.empty() || *end != '\0' || n < 1 || n > (1 << 24)) {
      std::cerr << "--n must be an integer in [1, " << (1 << 24)
                << "] (a zero/negative-length add proves nothing)\n";
      return 2;
    }
    gpuop::CudaAddResult res;
    gpuop::RunCudaAdd(lib, static_cast<int>(n), &res);
    if (!quiet) {
      std::cout << "{\"ok\":" << (res.ok ? "true" : "false")
                << ",\"n\":" << res.n << ",\"devices\":" << res.devices
                << ",\"cuda_driver_version\":\""
                << DriverApiVersion(res.driverVersion) << "\",\"libcuda\":\""
                << gpuop::JsonEscape(lib) << "\",\"device\":\""
                << gpuop::JsonEscape(res.device) << "\",\"cc\":\""
                << res.ccMajor << "." << res.ccMinor
                << "\",\"ms\":{\"init\":" << res.initMs
                << ",\"jit\":" << res.jitMs << ",\"add\":" << res.addMs
                << "},\"jit_log\":\"" << gpuop::JsonEscape(res.jitLog)
                << "\"";
      if (!res.ok) {
        std::cout << ",\"error\":\"" << gpuop::JsonEscape(res.error)
                  << "\",\"detail\":\"" << gpuop::JsonEscape(res.detail)
                  << "\"";
      }
      std::cout << "}" << std::endl;
    }
    return res.ok ? 0 : 1;
  }

  auto devices = gpuop::FindGpuDevices(devGlob);
  gpuop::DriverLibInfo info = gpuop::ProbeDriverLibrary(lib);
  bool ok = info.loadable && (!requireDevices || !devices.empty());

  if (!quiet) {
    std::cout << "{\"ok\":" << (ok ? "true" : "false") << ",\"devices\":[";
    for (size_t i = 0; i < devices.size(); ++i) {
      if (i) std::cout << ",";
      std::cout << "\"" << gpuop::JsonEscape(devices[i]) << "\"";
    }
    std::cout << "],\"libcuda\":\"" << gpuop::JsonEscape(info.path)
              << "\",\"loadable\":" << (info.loadable ? "true" : "false")
              << ",\"driver_api\":" << (info.driver_api ? "true" : "false")
              << "}" << std::endl;
  }
  return ok ? 0 : 1;
}
