// gpu-node-agent — host configuration agent: the driver and container
// toolkit operands of the GPU operator (SURVEY.md §2.3 rows 'NVIDIA kernel
// driver' and 'container toolkit'), as the TPU operator's node agent does
// them.
//
// Subcommands:
//   driver-install      stage the driver's user-space libraries from the
//                       operand image into the install dir (atomic rename),
//                       verify dlopen (and, with DRIVER_REQUIRED_VERSION or
//                       --required-version, the staged version), write the
//                       `driver` status file; then hold (DaemonSet main
//                       container).
//   runtime-configure   write the CDI spec for the node's cards and a
//                       containerd drop-in registering the `nvidia`
//                       handlers; write the `container-toolkit` status
//                       file; then hold.
//   cdi-generate        just emit the CDI spec (debugging / host tooling).
//   probe               print what the agent sees (cards, libcuda).
//
// The kernel module is the host's: this agent stages the user-space half
// of the driver (libcuda.so.1 and the libraries beside it), which must be
// of the module's version; the validator's driver component checks that.
//
// A card counts when it is present: where NVML loads, when NVML lists its
// node's number; without NVML, when its node is readable and writable.

#include <dirent.h>
#include <limits.h>
#include <signal.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdlib>
#include <cstring>
#include <iostream>
#include <set>
#include <sstream>
#include <string>
#include <vector>

#include "../common/nvml.h"
#include "../common/util.h"

namespace {

volatile sig_atomic_t g_stop = 0;
void HandleSignal(int) { g_stop = 1; }

constexpr char kDriverComponent[] = "driver";
constexpr char kToolkitComponent[] = "container-toolkit";

struct Options {
  // the user-space libraries as the operand image carries them
  std::string source = "/usr/share/gpu-operator/driver";
  std::string driverRoot = "/";
  std::string installDir;  // empty: <driver root>/usr/lib/x86_64-linux-gnu
  // the driver version the staged libcuda must carry (the operator's
  // per-product pin, driver.versionMap); empty: any
  std::string requiredVersion;
  std::string devGlob = gpuop::kDefaultDeviceGlob;
  std::string nvml = gpuop::kNvmlSoname;
  std::string cdiSpecDir = "/etc/cdi";
  std::string containerdConfig = "/etc/containerd/config.toml";
  std::string validationsDir = "/run/nvidia/validations";
  std::string resourceKind = "nvidia.com/gpu";
  // where the device plugin mounts the library too
  std::string libcudaContainerPath = "/usr/lib/x86_64-linux-gnu/libcuda.so.1";
  // worker-identity facts staged by the feature-discovery operand
  std::string workerEnvFile = "/run/nvidia/worker-env.d/worker-env";
  int refreshSeconds = 10;  // CDI spec re-derivation period
  bool oneshot = false;  // exit instead of holding (tests / jobs)

  std::string InstallDir() const {
    if (!installDir.empty()) return installDir;
    std::string base = driverRoot.back() == '/' ? driverRoot : driverRoot + "/";
    return base + gpuop::kDriverLibraryDirs[0];
  }
  std::string Libcuda() const {
    return gpuop::LibcudaPath(installDir, driverRoot);
  }
};

std::string StatusJson(const std::string& component, bool ok,
                       const std::string& detail) {
  std::ostringstream os;
  os << "{\"ok\":" << (ok ? "true" : "false") << ",\"ts\":"
     << gpuop::NowSeconds() << ",\"component\":\""
     << gpuop::JsonEscape(component) << "\",\"info\":{\"detail\":\""
     << gpuop::JsonEscape(detail) << "\"},\"writer\":\"gpu-node-agent\"}";
  return os.str();
}

bool WriteStatus(const Options& opt, const std::string& component, bool ok,
                 const std::string& detail) {
  gpuop::MkdirP(opt.validationsDir);
  return gpuop::WriteFileAtomic(
      opt.validationsDir + "/" + component + "-ready",
      StatusJson(component, ok, detail));
}

void RemoveStatus(const Options& opt, const std::string& component) {
  ::unlink((opt.validationsDir + "/" + component + "-ready").c_str());
}

void Hold(const Options& opt, const std::string& component) {
  if (opt.oneshot) return;
  signal(SIGTERM, HandleSignal);
  signal(SIGINT, HandleSignal);
  while (!g_stop) pause();
  // preStop parity: dependents must re-gate when this agent goes away
  RemoveStatus(opt, component);
}

// ---------------------------------------------------------------------------
// driver-install

// Is any other process holding one of the card nodes open? Scans
// /proc/*/fd (the DaemonSet runs with hostPID). Swapping libcuda.so.1
// under a running CUDA program would break the program: a re-dlopen or a
// forked child would see a library of another version than its context.
bool AnyDeviceInUse(const std::vector<std::string>& devices) {
  if (devices.empty()) return false;
  std::set<std::string> devset(devices.begin(), devices.end());
  DIR* proc = ::opendir("/proc");
  if (!proc) return false;
  bool inUse = false;
  pid_t self = ::getpid();
  struct dirent* e;
  while (!inUse && (e = ::readdir(proc)) != nullptr) {
    if (e->d_name[0] < '0' || e->d_name[0] > '9') continue;
    if (::atoi(e->d_name) == static_cast<int>(self)) continue;
    std::string fdDir = std::string("/proc/") + e->d_name + "/fd";
    DIR* fds = ::opendir(fdDir.c_str());
    if (!fds) continue;
    struct dirent* f;
    while ((f = ::readdir(fds)) != nullptr) {
      if (f->d_name[0] == '.') continue;
      char buf[PATH_MAX];
      ssize_t n = ::readlink((fdDir + "/" + f->d_name).c_str(), buf,
                             sizeof(buf) - 1);
      if (n <= 0) continue;
      buf[n] = '\0';
      if (devset.count(buf)) {
        inUse = true;
        break;
      }
    }
    ::closedir(fds);
  }
  ::closedir(proc);
  return inUse;
}

// One library of the payload: a regular file (its bytes) or a symlink (its
// target), as the image carries it: libcuda.so.1 -> libcuda.so.<version>.
struct PayloadEntry {
  std::string name;
  bool link = false;
  std::string content;  // bytes, or the link's target
};

bool ReadEntry(const std::string& path, PayloadEntry* out) {
  struct stat st;
  if (::lstat(path.c_str(), &st) != 0) return false;
  if (S_ISLNK(st.st_mode)) {
    char buf[PATH_MAX];
    ssize_t n = ::readlink(path.c_str(), buf, sizeof(buf) - 1);
    if (n <= 0) return false;
    out->link = true;
    out->content.assign(buf, static_cast<size_t>(n));
    return true;
  }
  out->link = false;
  return S_ISREG(st.st_mode) && gpuop::ReadFile(path, &out->content);
}

// The user-space libraries in the image directory: every lib*.so* entry.
std::vector<PayloadEntry> ReadPayload(const std::string& dir) {
  std::vector<PayloadEntry> out;
  DIR* d = ::opendir(dir.c_str());
  if (!d) return out;
  while (dirent* e = ::readdir(d)) {
    std::string name = e->d_name;
    if (name.rfind("lib", 0) != 0 || name.find(".so") == std::string::npos)
      continue;
    PayloadEntry entry;
    entry.name = name;
    if (ReadEntry(dir + "/" + name, &entry)) out.push_back(entry);
  }
  ::closedir(d);
  return out;
}

bool StageEntry(const PayloadEntry& e, const std::string& tmp) {
  ::unlink(tmp.c_str());
  if (e.link) return ::symlink(e.content.c_str(), tmp.c_str()) == 0;
  std::ofstream f(tmp, std::ios::trunc | std::ios::binary);
  if (!f) return false;
  f << e.content;
  return static_cast<bool>(f.flush());
}

int DriverInstall(const Options& opt) {
  // failure must retract a previously green status — dependents re-gate
  // (parity with the Python Component.clear_status() on failure)
  std::string dir = opt.InstallDir();
  std::string dest = dir + "/libcuda.so.1";
  auto payload = ReadPayload(opt.source);
  bool hasLibcuda = false;
  for (const auto& e : payload) hasLibcuda |= e.name == "libcuda.so.1";
  if (hasLibcuda) {
    std::vector<PayloadEntry> changed;
    bool replacing = false;
    for (const auto& e : payload) {
      PayloadEntry existing;
      std::string path = dir + "/" + e.name;
      bool have = ReadEntry(path, &existing);
      if (have && existing.link == e.link && existing.content == e.content)
        continue;
      changed.push_back(e);
      // presence, not readability, decides "swap vs fresh install": an
      // existing-but-unreadable dest is still a library a running program
      // may have mapped — it must get the in-use wait too
      struct stat st;
      replacing |= ::lstat(path.c_str(), &st) == 0;
    }
    if (!changed.empty()) {
      signal(SIGTERM, HandleSignal);
      signal(SIGINT, HandleSignal);
      // stage the payload FIRST (writing tens of MB is the slow part), so
      // the in-use check runs immediately before the commit renames
      gpuop::MkdirP(dir);
      auto unstage = [&]() {
        for (const auto& e : changed)
          ::unlink((dir + "/" + e.name + ".tmp").c_str());
      };
      for (const auto& e : changed) {
        if (!StageEntry(e, dir + "/" + e.name + ".tmp")) {
          std::cerr << "driver-install: cannot write " << dir << "/"
                    << e.name << ".tmp\n";
          unstage();  // don't strand a partial payload
          RemoveStatus(opt, kDriverComponent);
          return 1;
        }
      }
      while (replacing &&
             AnyDeviceInUse(gpuop::FindGpuDevices(opt.devGlob))) {
        if (opt.oneshot) {
          std::cerr << "driver-install: GPU device in use; refusing to swap "
                    << dest << "\n";
          unstage();
          return 3;
        }
        std::cerr << "driver-install: GPU device in use; waiting to swap "
                  << dest << "\n";
        for (int i = 0; i < 5 && !g_stop; i++) sleep(1);
        if (g_stop) {
          unstage();
          return 0;
        }
      }
      // the versioned files first, libcuda.so.1 last: the name a program
      // opens never points at a file not yet in place
      for (int pass = 0; pass < 2; ++pass) {
        for (const auto& e : changed) {
          if ((e.name == "libcuda.so.1") != (pass == 1)) continue;
          std::string path = dir + "/" + e.name;
          if (::rename((path + ".tmp").c_str(), path.c_str()) != 0) {
            std::cerr << "driver-install: cannot commit " << path << "\n";
            unstage();
            RemoveStatus(opt, kDriverComponent);
            return 1;
          }
          if (!e.link) ::chmod(path.c_str(), 0755);
        }
      }
    }
  } else if (access(dest.c_str(), F_OK) != 0) {
    // no payload in the image and nothing pre-installed (a host driver
    // install counts as installed)
    std::cerr << "driver-install: no libcuda.so.1 in " << opt.source
              << " and nothing at " << dest << "\n";
    RemoveStatus(opt, kDriverComponent);
    return 1;
  }
  gpuop::DriverLibInfo info = gpuop::ProbeDriverLibrary(dest);
  if (!info.loadable) {
    std::cerr << "driver-install: " << dest << " not loadable\n";
    RemoveStatus(opt, kDriverComponent);
    return 1;
  }
  if (!opt.requiredVersion.empty()) {
    long long want = gpuop::DriverVersionEpoch(opt.requiredVersion);
    long long have = gpuop::StagedDriverEpoch(dest);
    if (want < 0 || have != want) {
      std::cerr << "driver-install: " << dest << " is not driver version "
                << opt.requiredVersion << " (DRIVER_REQUIRED_VERSION)\n";
      RemoveStatus(opt, kDriverComponent);
      return 1;
    }
  }
  auto devices = gpuop::PresentGpuDevices(opt.devGlob, opt.nvml);
  if (devices.empty()) {
    std::cerr << "driver-install: no GPU devices match " << opt.devGlob
              << "\n";
    RemoveStatus(opt, kDriverComponent);
    return 1;
  }
  WriteStatus(opt, kDriverComponent, true,
              dest + (info.driver_api ? " (cuInit)" : ""));
  std::cout << "driver installed at " << dest << ", " << devices.size()
            << " device(s)\n";
  Hold(opt, kDriverComponent);
  return 0;
}

// ---------------------------------------------------------------------------
// CDI spec + containerd drop-in

std::string DeviceNodes(const std::vector<std::string>& paths) {
  std::ostringstream os;
  for (size_t i = 0; i < paths.size(); ++i) {
    os << "{\"path\": \"" << gpuop::JsonEscape(paths[i]) << "\"}"
       << (i + 1 < paths.size() ? ", " : "");
  }
  return os.str();
}

// The NVIDIA container toolkit's spec shape: one device a card, named by
// its minor number (the name the device plugin's CDI strategy asks for,
// nvidia.com/gpu=<N>), a composite "all", and global edits holding the
// control nodes, the driver library mount and the workload env.
std::string CdiSpecJson(const Options& opt,
                        const std::vector<std::string>& devices,
                        const std::string& libcudaHostPath) {
  std::ostringstream os;
  os << "{\n  \"cdiVersion\": \"0.6.0\",\n  \"kind\": \""
     << opt.resourceKind << "\",\n  \"devices\": [\n";
  for (const auto& d : devices) {
    os << "    {\"name\": \"" << gpuop::NodeNumber(d)
       << "\", \"containerEdits\": {\"deviceNodes\": [" << DeviceNodes({d})
       << "]}},\n";
  }
  os << "    {\"name\": \"all\", \"containerEdits\": {\"deviceNodes\": ["
     << DeviceNodes(devices) << "]}}\n";
  os << "  ],\n  \"containerEdits\": {\n";
  auto control = gpuop::FindControlNodes(opt.devGlob);
  if (!control.empty()) {
    os << "    \"deviceNodes\": [" << DeviceNodes(control) << "],\n";
  }
  if (!libcudaHostPath.empty()) {
    os << "    \"mounts\": [{\"hostPath\": \""
       << gpuop::JsonEscape(libcudaHostPath) << "\", \"containerPath\": \""
       << opt.libcudaContainerPath
       << "\", \"options\": [\"ro\", \"rbind\"]}],\n";
  }
  auto env = gpuop::WorkloadEnv(opt.workerEnvFile);
  os << "    \"env\": [";
  for (size_t i = 0; i < env.size(); ++i) {
    os << (i ? ", " : "") << "\"" << gpuop::JsonEscape(env[i].first) << "="
       << gpuop::JsonEscape(env[i].second) << "\"";
  }
  os << "]\n  }\n}\n";
  return os.str();
}

// containerd drop-in registering runc-backed handlers for the nvidia
// RuntimeClasses and enabling CDI injection (containerd >= 1.7). The file
// name is the one the validator's container-toolkit component looks for.
std::string ContainerdDropIn(const Options& opt) {
  std::ostringstream os;
  os << "# generated by gpu-node-agent; imported from " << opt.containerdConfig
     << "\n"
     << "version = 2\n\n"
     << "[plugins.\"io.containerd.grpc.v1.cri\"]\n"
     << "  enable_cdi = true\n"
     << "  cdi_spec_dirs = [\"" << opt.cdiSpecDir << "\"]\n\n"
     << "[plugins.\"io.containerd.grpc.v1.cri\".containerd.runtimes.nvidia]\n"
     << "  runtime_type = \"io.containerd.runc.v2\"\n"
     << "  pod_annotations = [\"nvidia.com/*\", \"cdi.k8s.io/*\"]\n\n"
     << "[plugins.\"io.containerd.grpc.v1.cri\".containerd.runtimes."
        "nvidia-cdi]\n"
     << "  runtime_type = \"io.containerd.runc.v2\"\n"
     << "  pod_annotations = [\"nvidia.com/*\", \"cdi.k8s.io/*\"]\n";
  return os.str();
}

std::string CdiSpecPath(const Options& opt) {
  return opt.cdiSpecDir + "/nvidia.json";
}

int RuntimeConfigure(const Options& opt) {
  auto devices = gpuop::PresentGpuDevices(opt.devGlob, opt.nvml);
  if (devices.empty()) {
    std::cerr << "runtime-configure: no GPU devices match " << opt.devGlob
              << "\n";
    RemoveStatus(opt, kToolkitComponent);
    return 1;
  }
  std::string libcuda = opt.Libcuda();
  gpuop::MkdirP(opt.cdiSpecDir);
  std::string spec = CdiSpecJson(opt, devices, libcuda);
  if (!gpuop::WriteFileAtomic(CdiSpecPath(opt), spec)) {
    std::cerr << "runtime-configure: cannot write CDI spec\n";
    RemoveStatus(opt, kToolkitComponent);
    return 1;
  }
  std::string confD =
      opt.containerdConfig.substr(0, opt.containerdConfig.rfind('/')) +
      "/conf.d";
  gpuop::MkdirP(confD);
  if (!gpuop::WriteFileAtomic(confD + "/nvidia-container-runtime.toml",
                              ContainerdDropIn(opt))) {
    std::cerr << "runtime-configure: cannot write containerd drop-in\n";
    RemoveStatus(opt, kToolkitComponent);
    return 1;
  }
  WriteStatus(opt, kToolkitComponent, true,
              std::to_string(devices.size()) + " devices in CDI spec");
  std::cout << "CDI spec + containerd drop-in written (" << devices.size()
            << " devices)\n";
  if (opt.oneshot) return 0;
  // Level-triggered hold: the spec's inputs change underneath us — the
  // feature-discovery operand writes the worker-env file on its own loop
  // (it may not exist yet when this pod starts), cards can appear, and a
  // new multi-node job changes WORKER_HOSTNAMES. Re-derive the spec
  // periodically and rewrite only on difference.
  signal(SIGTERM, HandleSignal);
  signal(SIGINT, HandleSignal);
  while (!g_stop) {
    for (int i = 0; i < opt.refreshSeconds && !g_stop; ++i) sleep(1);
    if (g_stop) break;
    devices = gpuop::PresentGpuDevices(opt.devGlob, opt.nvml);
    if (devices.empty()) continue;  // transient /dev flap: keep last spec
    libcuda = opt.Libcuda();
    std::string next = CdiSpecJson(opt, devices, libcuda);
    if (next != spec && gpuop::WriteFileAtomic(CdiSpecPath(opt), next)) {
      spec = next;
      WriteStatus(opt, kToolkitComponent, true,
                  std::to_string(devices.size()) + " devices in CDI spec");
      std::cout << "CDI spec refreshed (" << devices.size() << " devices)\n";
    }
  }
  RemoveStatus(opt, kToolkitComponent);
  return 0;
}

int Probe(const Options& opt) {
  auto devices = gpuop::PresentGpuDevices(opt.devGlob, opt.nvml);
  gpuop::DriverLibInfo info = gpuop::ProbeDriverLibrary(opt.Libcuda());
  std::cout << "{\"devices\":" << devices.size() << ",\"libcuda\":\""
            << gpuop::JsonEscape(info.path) << "\",\"loadable\":"
            << (info.loadable ? "true" : "false") << "}" << std::endl;
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::cerr << "usage: gpu-node-agent "
                 "{driver-install|runtime-configure|cdi-generate|probe} "
                 "[flags]\n";
    return 2;
  }
  std::string cmd = argv[1];
  Options opt;
  // env provides defaults (how the operator passes config); explicit flags
  // parsed below take precedence — same order as the Python components
  if (const char* v = getenv("NVIDIA_DRIVER_ROOT")) opt.driverRoot = v;
  if (const char* v = getenv("DRIVER_INSTALL_DIR")) opt.installDir = v;
  if (const char* v = getenv("DRIVER_REQUIRED_VERSION"))
    opt.requiredVersion = v;
  if (const char* v = getenv("GPU_DEVICE_GLOB")) opt.devGlob = v;
  if (const char* v = getenv("CDI_SPEC_DIR")) opt.cdiSpecDir = v;
  if (const char* v = getenv("CONTAINERD_CONFIG")) opt.containerdConfig = v;
  if (const char* v = getenv("WORKER_ENV_FILE")) opt.workerEnvFile = v;
  for (int i = 2; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](std::string* dst) {
      if (i + 1 >= argc) {
        std::cerr << "missing value for " << a << "\n";
        exit(2);
      }
      *dst = argv[++i];
    };
    if (a == "--source") next(&opt.source);
    else if (a == "--driver-root") next(&opt.driverRoot);
    else if (a == "--install-dir") next(&opt.installDir);
    else if (a == "--required-version") next(&opt.requiredVersion);
    else if (a == "--device-glob") next(&opt.devGlob);
    else if (a == "--nvml") next(&opt.nvml);
    else if (a == "--cdi-spec-dir") next(&opt.cdiSpecDir);
    else if (a == "--containerd-config") next(&opt.containerdConfig);
    else if (a == "--validations-dir") next(&opt.validationsDir);
    else if (a == "--resource-kind") next(&opt.resourceKind);
    else if (a == "--worker-env-file") next(&opt.workerEnvFile);
    else if (a == "--refresh-seconds") {
      std::string v;
      next(&v);
      opt.refreshSeconds = std::stoi(v);
    }
    else if (a == "--oneshot") opt.oneshot = true;
    else {
      std::cerr << "unknown flag: " << a << "\n";
      return 2;
    }
  }
  if (opt.driverRoot.empty()) opt.driverRoot = "/";
  if (cmd == "driver-install") return DriverInstall(opt);
  if (cmd == "runtime-configure") return RuntimeConfigure(opt);
  if (cmd == "cdi-generate") {
    auto devices = gpuop::PresentGpuDevices(opt.devGlob, opt.nvml);
    std::cout << CdiSpecJson(opt, devices, opt.Libcuda());
    return devices.empty() ? 1 : 0;
  }
  if (cmd == "probe") return Probe(opt);
  std::cerr << "unknown subcommand: " << cmd << "\n";
  return 2;
}
