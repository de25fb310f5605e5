// gpu-oci-hook — OCI createRuntime hook injecting GPUs into containers: the
// nvidia-container-runtime hook of the container toolkit operand (SURVEY.md
// §2.3 row 'NVIDIA container toolkit'), as the TPU operator's hook does it.
// CDI (written by gpu-node-agent runtime-configure) is the preferred path
// on containerd >= 1.7; this hook covers CRI-O/podman via a hooks.d
// config. It edits the container's OCI config.json in place: the cards'
// and the driver's control nodes' character devices into linux.devices
// (with their real major/minor, + the cgroup device allow-list), a
// read-only libcuda.so.1 bind mount, and the workload env.
//
// Activation contract (the NVIDIA toolkit's): the hook is a no-op unless
// the container's process.env carries NVIDIA_VISIBLE_DEVICES (set by the
// device plugin on allocation, or by the user) or the pod carries the
// annotation nvidia.com/inject. Values: "all" or comma-separated cards,
// each the N of /dev/nvidiaN or the card's NVML UUID (GPU-..., the name the
// device plugin gives where NVML loads; NVML resolves it to the card's
// node); "void" and "none" inject nothing.
//
// Subcommands:
//   create-runtime            hook mode — container state JSON on stdin
//   inject --bundle DIR       direct mode (tests / debugging)
//   hook-config               emit a hooks.d JSON config for CRI-O/podman
//   install --dest DIR        copy self onto the host + write hooks.d config

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <unistd.h>

#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#include "../common/json.h"
#include "../common/nvml.h"
#include "../common/util.h"

namespace {

using gpuop::json::Type;
using gpuop::json::Value;
using gpuop::json::ValuePtr;

struct Options {
  std::string bundle;
  std::string devGlob = gpuop::kDefaultDeviceGlob;
  std::string nvml = gpuop::kNvmlSoname;
  std::string driverRoot = "/";
  std::string installDir;  // empty: the first staged copy under the root
  std::string libcudaContainerPath = "/usr/lib/x86_64-linux-gnu/libcuda.so.1";
  std::string devices;   // override selection ("all" | "0,2"); direct mode
  std::string hookPath = "/usr/local/bin/gpu-oci-hook";
  std::string dest;      // install destination dir (as seen by this process)
  std::string hostDest;  // the same dir as the HOST sees it (hooks.d path)
  std::string hooksD;    // hooks.d dir for install
  // worker-identity facts staged by the feature-discovery operand
  std::string workerEnvFile = "/run/nvidia/worker-env.d/worker-env";
  bool allowNonChar = false;  // tests use regular files as device stand-ins
};

constexpr char kEnvKey[] = "NVIDIA_VISIBLE_DEVICES";
constexpr char kAnnotationKey[] = "nvidia.com/inject";

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::istringstream ss(s);
  std::string part;
  while (std::getline(ss, part, sep))
    if (!part.empty()) out.push_back(part);
  return out;
}

// Card selection from an activation value: "all" (or "") selects every
// present card, otherwise comma-separated cards, each a node number or an
// NVML UUID.
std::vector<std::string> SelectDevices(const Options& opt,
                                       const std::string& value) {
  auto cards = gpuop::PresentGpuNodes(opt.devGlob, opt.nvml);
  std::vector<std::string> out;
  if (value.empty() || value == "all") {
    for (const auto& card : cards) out.push_back(card.path);
    return out;
  }
  for (const auto& name : Split(value, ',')) {
    for (const auto& card : cards) {
      if (name == card.uuid || name == std::to_string(card.number))
        out.push_back(card.path);
    }
  }
  return out;
}

// The activation value; false when the container did not ask for GPUs
// (the hook must then be a no-op).
bool ActivationValue(const ValuePtr& config, std::string* value) {
  ValuePtr process = config->Get("process");
  if (process != nullptr) {
    ValuePtr env = process->Get("env");
    if (env != nullptr && env->type == Type::Array) {
      const std::string prefix = std::string(kEnvKey) + "=";
      for (const auto& e : env->arr) {
        if (e->type == Type::String && e->str.rfind(prefix, 0) == 0) {
          *value = e->str.substr(prefix.size());
          return *value != "void" && *value != "none";
        }
      }
    }
  }
  ValuePtr ann = config->Get("annotations");
  if (ann != nullptr) {
    ValuePtr v = ann->Get(kAnnotationKey);
    if (v != nullptr && v->type == Type::String && v->str != "false") {
      *value = v->str == "true" ? "all" : v->str;
      return true;
    }
  }
  return false;
}

// Returns nullptr when the path is not an injectable device (vanished
// between glob and stat, not a character device, or a placeholder node of
// device number 0:0, as containers hold for nvidia-uvm-tools) — injecting a
// bogus c 0:0 node would fail opaquely inside the workload instead of
// loudly here.
ValuePtr DeviceEntry(const std::string& path, bool allowNonChar) {
  struct stat st{};
  if (stat(path.c_str(), &st) != 0) return nullptr;
  unsigned maj = 0, min = 0;
  if (S_ISCHR(st.st_mode) && st.st_rdev != 0) {
    maj = major(st.st_rdev);
    min = minor(st.st_rdev);
  } else if (!allowNonChar) {
    return nullptr;
  }
  ValuePtr d = Value::MakeObject();
  d->Set("path", Value::MakeString(path));
  d->Set("type", Value::MakeString("c"));
  d->Set("major", Value::MakeNumber(maj));
  d->Set("minor", Value::MakeNumber(min));
  d->Set("fileMode", Value::MakeNumber(0666));
  d->Set("uid", Value::MakeNumber(0));
  d->Set("gid", Value::MakeNumber(0));
  return d;
}

bool HasDevice(const ValuePtr& devices, const std::string& path) {
  for (const auto& d : devices->arr) {
    ValuePtr p = d->Get("path");
    if (p != nullptr && p->str == path) return true;
  }
  return false;
}

bool HasMountAt(const ValuePtr& mounts, const std::string& destination) {
  for (const auto& m : mounts->arr) {
    ValuePtr d = m->Get("destination");
    if (d != nullptr && d->str == destination) return true;
  }
  return false;
}

void EnsureEnv(const ValuePtr& env, const std::string& key,
               const std::string& value) {
  const std::string prefix = key + "=";
  for (const auto& e : env->arr)
    if (e->type == Type::String && e->str.rfind(prefix, 0) == 0) return;
  env->arr.push_back(Value::MakeString(prefix + value));
}

// Adds `path` to linux.devices and the cgroup allow-list; false when it is
// not injectable.
bool Inject(const Options& opt, const ValuePtr& devArr,
            const ValuePtr& allowArr, const std::string& path) {
  if (HasDevice(devArr, path)) return true;
  ValuePtr entry = DeviceEntry(path, opt.allowNonChar);
  if (entry == nullptr) {
    std::cerr << "gpu-oci-hook: skipping " << path
              << " (not a character device)\n";
    return false;
  }
  ValuePtr allow = Value::MakeObject();
  allow->Set("allow", Value::MakeBool(true));
  allow->Set("type", Value::MakeString("c"));
  allow->Set("major", std::make_shared<Value>(*entry->Get("major")));
  allow->Set("minor", std::make_shared<Value>(*entry->Get("minor")));
  allow->Set("access", Value::MakeString("rwm"));
  devArr->arr.push_back(entry);
  allowArr->arr.push_back(allow);
  return true;
}

// Core edit: returns the number of cards injected, -1 on error.
int EditConfig(const Options& opt, const ValuePtr& config,
               const std::string& activation) {
  auto devices = SelectDevices(opt, activation);
  if (devices.empty()) {
    std::cerr << "gpu-oci-hook: no GPU devices match " << opt.devGlob
              << " selection '" << activation << "'\n";
    return -1;
  }
  ValuePtr linux_ = config->GetOrCreate("linux", Type::Object);
  ValuePtr devArr = linux_->GetOrCreate("devices", Type::Array);
  ValuePtr resources = linux_->GetOrCreate("resources", Type::Object);
  ValuePtr allowArr = resources->GetOrCreate("devices", Type::Array);
  int injected = 0;
  for (const auto& path : devices)
    injected += Inject(opt, devArr, allowArr, path) ? 1 : 0;
  if (injected == 0) {
    std::cerr << "gpu-oci-hook: no injectable GPU devices\n";
    return -1;
  }
  // every CUDA program opens the control nodes beside its cards'
  for (const auto& path : gpuop::FindControlNodes(opt.devGlob))
    Inject(opt, devArr, allowArr, path);

  std::string libcuda = gpuop::LibcudaPath(opt.installDir, opt.driverRoot);
  if (!libcuda.empty()) {
    ValuePtr mounts = config->GetOrCreate("mounts", Type::Array);
    if (!HasMountAt(mounts, opt.libcudaContainerPath)) {
      ValuePtr m = Value::MakeObject();
      m->Set("destination", Value::MakeString(opt.libcudaContainerPath));
      m->Set("type", Value::MakeString("bind"));
      m->Set("source", Value::MakeString(libcuda));
      ValuePtr mopts = Value::MakeArray();
      for (const char* o : {"ro", "rbind", "nosuid", "nodev"})
        mopts->arr.push_back(Value::MakeString(o));
      m->Set("options", mopts);
      mounts->arr.push_back(m);
    }
  }

  ValuePtr process = config->GetOrCreate("process", Type::Object);
  ValuePtr env = process->GetOrCreate("env", Type::Array);
  EnsureEnv(env, kEnvKey, activation.empty() ? "all" : activation);
  // the rest of the workload env must match the CDI path's
  for (const auto& kv : gpuop::WorkloadEnv(opt.workerEnvFile))
    EnsureEnv(env, kv.first, kv.second);
  return injected;
}

int InjectBundle(const Options& opt) {
  std::string configPath = opt.bundle + "/config.json";
  std::string text;
  if (!gpuop::ReadFile(configPath, &text)) {
    std::cerr << "gpu-oci-hook: cannot read " << configPath << "\n";
    return 1;
  }
  std::string err;
  ValuePtr config = gpuop::json::Parse(text, &err);
  if (config == nullptr) {
    std::cerr << "gpu-oci-hook: bad config.json: " << err << "\n";
    return 1;
  }
  std::string activation = opt.devices;
  if (activation.empty() && !ActivationValue(config, &activation)) {
    // container did not ask for GPUs — mandatory no-op success
    return 0;
  }
  int n = EditConfig(opt, config, activation);
  if (n < 0) return 1;
  if (!gpuop::WriteFileAtomic(configPath, gpuop::json::Serialize(config))) {
    std::cerr << "gpu-oci-hook: cannot write " << configPath << "\n";
    return 1;
  }
  std::cerr << "gpu-oci-hook: injected " << n << " device(s) into "
            << configPath << "\n";
  return 0;
}

int CreateRuntime(Options opt) {
  // hook contract: container state JSON on stdin carries the bundle path
  std::ostringstream ss;
  ss << std::cin.rdbuf();
  std::string err;
  ValuePtr state = gpuop::json::Parse(ss.str(), &err);
  if (state == nullptr) {
    std::cerr << "gpu-oci-hook: bad state on stdin: " << err << "\n";
    return 1;
  }
  ValuePtr bundle = state->Get("bundle");
  if (bundle == nullptr || bundle->type != Type::String) {
    std::cerr << "gpu-oci-hook: state has no bundle path\n";
    return 1;
  }
  opt.bundle = bundle->str;
  return InjectBundle(opt);
}

// hooks.d config for CRI-O / podman (oci-hooks(5) schema).
std::string HookConfigJson(const Options& opt) {
  ValuePtr root = Value::MakeObject();
  root->Set("version", Value::MakeString("1.0.0"));
  ValuePtr hook = Value::MakeObject();
  hook->Set("path", Value::MakeString(opt.hookPath));
  ValuePtr args = Value::MakeArray();
  args->arr.push_back(Value::MakeString("gpu-oci-hook"));
  args->arr.push_back(Value::MakeString("create-runtime"));
  hook->Set("args", args);
  // The runtime execs the installed hook with the RUNTIME's environment,
  // not this installer's — so the operator-provided config (multi-node
  // toggle, paths) must be baked into the hooks.d entry's env, or
  // WorkloadEnv in the real createRuntime call would see nothing. A CR
  // change rolls the DaemonSet, re-runs install, and rewrites this file.
  ValuePtr henv = Value::MakeArray();
  // an empty DRIVER_INSTALL_DIR reads as unset: libcuda under the root
  henv->arr.push_back(Value::MakeString(
      "DRIVER_INSTALL_DIR=" + opt.installDir));
  henv->arr.push_back(Value::MakeString("GPU_DEVICE_GLOB=" + opt.devGlob));
  henv->arr.push_back(Value::MakeString(
      "WORKER_ENV_FILE=" + opt.workerEnvFile));
  henv->arr.push_back(Value::MakeString(
      "NVIDIA_DRIVER_ROOT=" + opt.driverRoot));
  for (const char* key : {"MULTINODE_ENABLED", "MASTER_PORT"}) {
    if (const char* v = getenv(key))
      henv->arr.push_back(Value::MakeString(std::string(key) + "=" + v));
  }
  hook->Set("env", henv);
  root->Set("hook", hook);
  ValuePtr when = Value::MakeObject();
  ValuePtr ann = Value::MakeObject();
  ann->Set(kAnnotationKey, Value::MakeString("true"));
  when->Set("annotations", ann);
  root->Set("when", when);
  ValuePtr stages = Value::MakeArray();
  stages->arr.push_back(Value::MakeString("createRuntime"));
  root->Set("stages", stages);
  return gpuop::json::Serialize(root);
}

int Install(const Options& opt) {
  if (opt.dest.empty()) {
    std::cerr << "install: --dest required\n";
    return 2;
  }
  // argv[0] may be a bare PATH-resolved name (DaemonSet command lists);
  // /proc/self/exe is always the real binary
  std::string content;
  if (!gpuop::ReadFile("/proc/self/exe", &content)) {
    std::cerr << "install: cannot read /proc/self/exe\n";
    return 1;
  }
  gpuop::MkdirP(opt.dest);
  std::string target = opt.dest + "/gpu-oci-hook";
  if (!gpuop::WriteFileAtomic(target, content)) {
    std::cerr << "install: cannot write " << target << "\n";
    return 1;
  }
  ::chmod(target.c_str(), 0755);
  if (!opt.hooksD.empty()) {
    Options hooked = opt;
    // the hooks.d config is read by the HOST runtime: reference the binary
    // by its host-visible path, not this container's mount of it
    std::string hostDir = opt.hostDest.empty() ? opt.dest : opt.hostDest;
    hooked.hookPath = hostDir + "/gpu-oci-hook";
    gpuop::MkdirP(opt.hooksD);
    if (!gpuop::WriteFileAtomic(opt.hooksD + "/99-gpu-oci-hook.json",
                                HookConfigJson(hooked))) {
      std::cerr << "install: cannot write hooks.d config\n";
      return 1;
    }
  }
  std::cout << "installed " << target << "\n";
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::cerr << "usage: gpu-oci-hook "
                 "{create-runtime|inject|hook-config|install} [flags]\n";
    return 2;
  }
  std::string cmd = argv[1];
  Options opt;
  if (const char* v = getenv("NVIDIA_DRIVER_ROOT")) opt.driverRoot = v;
  if (const char* v = getenv("DRIVER_INSTALL_DIR")) opt.installDir = v;
  if (const char* v = getenv("GPU_DEVICE_GLOB")) opt.devGlob = v;
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
    if (a == "--bundle") next(&opt.bundle);
    else if (a == "--device-glob") next(&opt.devGlob);
    else if (a == "--nvml") next(&opt.nvml);
    else if (a == "--driver-root") next(&opt.driverRoot);
    else if (a == "--install-dir") next(&opt.installDir);
    else if (a == "--libcuda-container-path") next(&opt.libcudaContainerPath);
    else if (a == "--devices") next(&opt.devices);
    else if (a == "--hook-path") next(&opt.hookPath);
    else if (a == "--dest") next(&opt.dest);
    else if (a == "--host-dest") next(&opt.hostDest);
    else if (a == "--hooks-d") next(&opt.hooksD);
    else if (a == "--worker-env-file") next(&opt.workerEnvFile);
    else if (a == "--allow-non-char") opt.allowNonChar = true;
    else {
      std::cerr << "unknown flag: " << a << "\n";
      return 2;
    }
  }
  if (opt.driverRoot.empty()) opt.driverRoot = "/";
  if (cmd == "create-runtime") return CreateRuntime(opt);
  if (cmd == "inject") {
    if (opt.bundle.empty()) {
      std::cerr << "inject: --bundle required\n";
      return 2;
    }
    return InjectBundle(opt);
  }
  if (cmd == "hook-config") {
    std::cout << HookConfigJson(opt);
    return 0;
  }
  if (cmd == "install") return Install(opt);
  std::cerr << "unknown subcommand: " << cmd << "\n";
  return 2;
}
