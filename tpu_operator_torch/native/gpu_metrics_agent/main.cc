// gpu-metrics-agent — node-local metrics daemon, the stand-in for the DCGM
// host engine (SURVEY.md §2.3 row 'DCGM host engine': a daemon on a local
// port that the exporter scrapes; this one speaks Prometheus text directly,
// so the exporter is a relabeling proxy, not a protocol translator).
//
// Sources:
//   - the card nodes (/dev/nvidia[0-9]*) and, through NVML
//     (libnvidia-ml.so.1 by dlopen), which of them are this container's
//     cards, their names and attributes, keyed by minor number;
//   - without NVML, per-card attribute files in the layout of
//     utils/nvml.py FileSource: <attr-root>/nvidia<N>/<attr>;
//   - libcuda.so.1: loadable, its driver-API version, and its version
//     against the running kernel module's as workload validation recorded
//     it (the skew gauge).
//
// Flags: --port (default 9401), --device-glob, --nvml, --attr-root,
// --install-dir, --driver-root, --validations-dir, --runtime-build-file,
// --once (print one scrape to stdout and exit — tests and debugging).

#include <arpa/inet.h>
#include <dirent.h>
#include <dlfcn.h>
#include <netinet/in.h>
#include <signal.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#include "../common/nvml.h"
#include "../common/util.h"

namespace {

struct Options {
  int port = 9401;
  std::string devGlob = gpuop::kDefaultDeviceGlob;
  std::string nvml = gpuop::kNvmlSoname;
  std::string attrRoot;  // FileSource layout, read where NVML is absent
  std::string driverRoot = "/";
  std::string installDir;  // empty: the first staged copy under the root
  // where workload validation records the RUNNING kernel module's version
  // (validator/driver_build.py runtime_build_file)
  std::string validationsDir = "/run/nvidia/validations";
  // full record path; empty = validationsDir + "/runtime-build". Honours
  // the same GPU_RUNTIME_BUILD_FILE override the Python validator does, or
  // a relocated record would silently darken the skew gauge.
  std::string runtimeBuildFile;
  bool once = false;
};

double g_start = gpuop::NowSeconds();

// `text` without trailing whitespace when it is a number as a whole (the
// exposition's value grammar), else "". Kept verbatim: a 64-bit counter
// printed through a double would lose its low digits.
std::string NumberText(const std::string& text) {
  std::string s = text;
  while (!s.empty() && std::isspace(static_cast<unsigned char>(s.back())))
    s.pop_back();
  if (s.empty()) return "";
  char* end = nullptr;
  std::strtod(s.c_str(), &end);
  return end != nullptr && *end == '\0' ? s : "";
}

// Per-card attributes from files: <root>/nvidia<N>/<attr>.
std::vector<std::pair<std::string, std::vector<std::pair<std::string,
                                                         std::string>>>>
FileAttributes(const std::string& root) {
  std::vector<std::pair<std::string,
                        std::vector<std::pair<std::string, std::string>>>>
      out;
  if (root.empty()) return out;
  DIR* dir = opendir(root.c_str());
  if (!dir) return out;
  std::vector<std::string> cards;
  while (dirent* e = readdir(dir)) {
    std::string name = e->d_name;
    if (name.rfind("nvidia", 0) == 0 && name.size() > 6 &&
        name.find_first_not_of("0123456789", 6) == std::string::npos) {
      cards.push_back(name);
    }
  }
  closedir(dir);
  std::sort(cards.begin(), cards.end());
  for (const auto& card : cards) {
    std::vector<std::string> names;
    if (DIR* d = opendir((root + "/" + card).c_str())) {
      while (dirent* e = readdir(d))
        if (e->d_name[0] != '.') names.push_back(e->d_name);
      closedir(d);
    }
    std::sort(names.begin(), names.end());
    std::vector<std::pair<std::string, std::string>> attrs;
    for (const auto& n : names) {
      std::string value;
      if (gpuop::ReadFile(root + "/" + card + "/" + n, &value))
        attrs.emplace_back(n, value);
    }
    out.emplace_back(card, attrs);
  }
  return out;
}

// libcuda's driver-API version (cuDriverGetVersion needs no cuInit and
// touches no card), as "12.8"; "" when the library lacks it.
std::string CudaDriverVersion(const std::string& lib) {
  if (lib.empty()) return "";
  void* h = dlopen(lib.c_str(), RTLD_LAZY | RTLD_LOCAL);
  if (h == nullptr) return "";
  using Fn = int (*)(int*);
  auto fn = reinterpret_cast<Fn>(dlsym(h, "cuDriverGetVersion"));
  int v = 0;
  std::string out;
  if (fn != nullptr && fn(&v) == 0 && v > 0) {
    out = std::to_string(v / 1000) + "." + std::to_string((v % 1000) / 10);
  }
  dlclose(h);
  return out;
}

std::string Scrape(const Options& opt) {
  std::ostringstream os;
  gpuop::NvmlView nvml = gpuop::ReadNvml(opt.nvml);
  auto nodes = gpuop::ScanGpuNodes(opt.devGlob, nvml);
  size_t present = 0;
  for (const auto& n : nodes) present += n.present ? 1 : 0;

  os << "# HELP gpu_agent_up agent liveness\n"
     << "# TYPE gpu_agent_up gauge\ngpu_agent_up 1\n";
  os << "# HELP gpu_agent_uptime_seconds seconds since agent start\n"
     << "# TYPE gpu_agent_uptime_seconds gauge\n"
     << "gpu_agent_uptime_seconds " << (gpuop::NowSeconds() - g_start)
     << "\n";
  os << "# HELP gpu_agent_devices_total GPU device nodes present\n"
     << "# TYPE gpu_agent_devices_total gauge\n"
     << "gpu_agent_devices_total " << present << "\n";

  std::string lib = gpuop::LibcudaPath(opt.installDir, opt.driverRoot);
  gpuop::DriverLibInfo info = gpuop::ProbeDriverLibrary(lib);
  os << "# HELP gpu_agent_driver_loadable 1 if libcuda.so.1 dlopens\n"
     << "# TYPE gpu_agent_driver_loadable gauge\n"
     << "gpu_agent_driver_loadable " << (info.loadable ? 1 : 0) << "\n";
  // facts about the installed driver, as an info-style gauge (constant 1,
  // facts in labels), the DCGM build-info pattern
  std::vector<std::pair<std::string, std::string>> facts;
  std::string api = info.loadable ? CudaDriverVersion(lib) : "";
  if (!api.empty()) facts.emplace_back("cuda_driver_version", api);
  if (nvml.ok && !nvml.driverVersion.empty())
    facts.emplace_back("driver_version", nvml.driverVersion);
  if (!facts.empty()) {
    os << "# HELP gpu_agent_driver_info driver facts\n"
       << "# TYPE gpu_agent_driver_info gauge\n";
    for (const auto& f : facts) {
      os << "gpu_agent_driver_info{name=\"" << f.first << "\",value=\""
         << gpuop::JsonEscape(f.second) << "\"} 1\n";
    }
  }

  // version-skew family: the staged user-space library's version against
  // the running kernel module's, recorded by workload validation. During
  // a driver upgrade they diverge, and every CUDA call on the node fails
  // with "Driver/library version mismatch" — the node-level alert signal.
  long long staged = gpuop::StagedDriverEpoch(lib);
  long long runtime = -1;
  {
    std::string path = opt.runtimeBuildFile.empty()
                           ? opt.validationsDir + "/runtime-build"
                           : opt.runtimeBuildFile;
    std::string recorded;
    if (gpuop::ReadFile(path, &recorded)) {
      runtime = gpuop::DriverVersionEpoch(recorded);
    }
  }
  if (staged >= 0 || runtime >= 0) {
    os << "# HELP gpu_agent_driver_build_epoch driver version as "
          "major*1e6+minor*1e3+patch by source (staged library vs running "
          "kernel module)\n"
       << "# TYPE gpu_agent_driver_build_epoch gauge\n";
    if (staged >= 0) {
      os << "gpu_agent_driver_build_epoch{source=\"staged\"} " << staged
         << "\n";
    }
    if (runtime >= 0) {
      os << "gpu_agent_driver_build_epoch{source=\"runtime\"} " << runtime
         << "\n";
    }
  }
  if (staged >= 0 && runtime >= 0) {
    os << "# HELP gpu_agent_driver_skew 1 if the staged user-space library "
          "and the running kernel module are different driver versions\n"
       << "# TYPE gpu_agent_driver_skew gauge\n"
       << "gpu_agent_driver_skew " << (staged != runtime ? 1 : 0) << "\n";
  }

  os << "# HELP gpu_agent_device_present per-device presence\n"
     << "# TYPE gpu_agent_device_present gauge\n";
  for (const auto& n : nodes) {
    os << "gpu_agent_device_present{device=\"" << gpuop::JsonEscape(n.path)
       << "\"";
    const gpuop::NvmlCard* card = nvml.Card(n.number);
    if (card != nullptr) {
      for (const auto& kv : card->attrs)
        if (kv.first == "name")
          os << ",name=\"" << gpuop::JsonEscape(kv.second) << "\"";
    }
    os << "} " << (n.present ? 1 : 0) << "\n";
  }

  // per-card attributes, exported as gpu_agent_device_attr{device="nvidiaN"}
  // where the value is a number (the name is a label above; nvlink_down
  // lists links and is read from nvlink_up's 0)
  std::vector<std::pair<std::string,
                        std::vector<std::pair<std::string, std::string>>>>
      cards;
  if (nvml.loaded) {
    for (const auto& c : nvml.cards)
      cards.emplace_back("nvidia" + std::to_string(c.minor), c.attrs);
  } else {
    cards = FileAttributes(opt.attrRoot);
  }
  bool wroteHeader = false;
  for (const auto& card : cards) {
    for (const auto& kv : card.second) {
      std::string v = NumberText(kv.second);
      if (kv.first == "nvlink_down" || v.empty()) continue;
      if (!wroteHeader) {
        os << "# HELP gpu_agent_device_attr per-device attribute\n"
           << "# TYPE gpu_agent_device_attr gauge\n";
        wroteHeader = true;
      }
      os << "gpu_agent_device_attr{device=\"" << card.first << "\",attr=\""
         << gpuop::JsonEscape(kv.first) << "\"} " << v << "\n";
    }
  }
  return os.str();
}

volatile sig_atomic_t g_stop = 0;
void HandleSignal(int) { g_stop = 1; }

int Serve(const Options& opt) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    perror("socket");
    return 1;
  }
  int on = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &on, sizeof(on));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(opt.port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    perror("bind");
    return 1;
  }
  if (listen(fd, 16) < 0) {
    perror("listen");
    return 1;
  }
  // report the actually-bound port (port 0 = ephemeral, used by tests)
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  std::cout << "gpu-metrics-agent listening on :" << ntohs(addr.sin_port)
            << std::endl;

  // sigaction without SA_RESTART so a SIGTERM interrupts the blocking
  // accept() (glibc signal() would auto-restart it and we'd never stop)
  struct sigaction sa{};
  sa.sa_handler = HandleSignal;
  sigaction(SIGTERM, &sa, nullptr);
  sigaction(SIGINT, &sa, nullptr);
  signal(SIGPIPE, SIG_IGN);
  while (!g_stop) {
    int client = accept(fd, nullptr, nullptr);
    if (client < 0) continue;
    char buf[2048];
    ssize_t n = read(client, buf, sizeof(buf) - 1);
    std::string request = n > 0 ? std::string(buf, static_cast<size_t>(n))
                                : std::string();
    std::string body, status = "200 OK",
                contentType = "text/plain; version=0.0.4; charset=utf-8";
    if (request.rfind("GET /metrics", 0) == 0) {
      body = Scrape(opt);
    } else if (request.rfind("GET /healthz", 0) == 0) {
      body = "ok\n";
    } else {
      status = "404 Not Found";
      body = "not found\n";
    }
    std::ostringstream resp;
    resp << "HTTP/1.1 " << status << "\r\nContent-Type: " << contentType
         << "\r\nContent-Length: " << body.size()
         << "\r\nConnection: close\r\n\r\n" << body;
    std::string out = resp.str();
    (void)!write(client, out.data(), out.size());
    close(client);
  }
  close(fd);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  Options opt;
  // env = defaults, flags override (parsed after)
  if (const char* v = getenv("GPU_METRICS_AGENT_PORT")) opt.port = atoi(v);
  if (const char* v = getenv("GPU_DEVICE_GLOB")) opt.devGlob = v;
  if (const char* v = getenv("NVIDIA_DRIVER_ROOT")) opt.driverRoot = v;
  if (const char* v = getenv("DRIVER_INSTALL_DIR")) opt.installDir = v;
  if (const char* v = getenv("GPU_VALIDATIONS_DIR")) opt.validationsDir = v;
  if (const char* v = getenv("GPU_RUNTIME_BUILD_FILE")) {
    opt.runtimeBuildFile = v;
  }
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) {
        std::cerr << "missing value for " << a << "\n";
        exit(2);
      }
      return argv[++i];
    };
    if (a == "--port") opt.port = std::stoi(next());
    else if (a == "--device-glob") opt.devGlob = next();
    else if (a == "--nvml") opt.nvml = next();
    else if (a == "--attr-root") opt.attrRoot = next();
    else if (a == "--driver-root") opt.driverRoot = next();
    else if (a == "--install-dir") opt.installDir = next();
    else if (a == "--validations-dir") opt.validationsDir = next();
    else if (a == "--runtime-build-file") opt.runtimeBuildFile = next();
    else if (a == "--once") opt.once = true;
    else {
      std::cerr << "unknown flag: " << a << "\n";
      return 2;
    }
  }
  if (opt.once) {
    std::cout << Scrape(opt);
    return 0;
  }
  return Serve(opt);
}
