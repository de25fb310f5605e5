// Shared helpers for the GPU node agents.
//
// The GPU form of the TPU agents' helpers: small, dependency-free C++
// (glob, dlfcn, POSIX) so the operand images stay minimal. Nothing here
// includes a CUDA or NVML header; the driver's libraries are reached by
// dlopen only.
#pragma once

#include <dlfcn.h>
#include <glob.h>
#include <limits.h>
#include <stdlib.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <ctime>
#include <fstream>
#include <sstream>
#include <string>
#include <utility>
#include <vector>

namespace gpuop {

inline std::vector<std::string> Glob(const std::string& pattern) {
  std::vector<std::string> out;
  glob_t g{};
  if (glob(pattern.c_str(), 0, nullptr, &g) == 0) {
    for (size_t i = 0; i < g.gl_pathc; ++i) out.emplace_back(g.gl_pathv[i]);
  }
  globfree(&g);
  return out;
}

// One device node per card: /dev/nvidia0 ... /dev/nvidiaN. The glob must
// not match the control nodes (nvidiactl, nvidia-uvm, nvidia-modeset).
constexpr char kDefaultDeviceGlob[] = "/dev/nvidia[0-9]*";

// The nodes every CUDA container needs beside its cards' nodes.
const char* const kControlNodes[] = {"nvidiactl", "nvidia-uvm",
                                     "nvidia-uvm-tools"};

inline std::vector<std::string> FindGpuDevices(const std::string& devGlob) {
  return Glob(devGlob);
}

// The control nodes present in the directory the device glob points into.
// A character node of device number 0:0 is a placeholder (containers hold
// one for nvidia-uvm-tools where the host's is not passed through), not a
// device.
inline std::vector<std::string> FindControlNodes(const std::string& devGlob) {
  std::string dir = devGlob.substr(0, devGlob.rfind('/') + 1);
  std::vector<std::string> out;
  for (const char* n : kControlNodes) {
    std::string path = dir + n;
    struct stat st;
    if (::stat(path.c_str(), &st) == 0 &&
        !(S_ISCHR(st.st_mode) && st.st_rdev == 0)) {
      out.push_back(path);
    }
  }
  return out;
}

// The card's number: the trailing digits of its node's name (nvidia5 → 5),
// the number NVML's nvmlDeviceGetMinorNumber gives; -1 without digits.
inline long NodeNumber(const std::string& path) {
  size_t d = path.find_last_not_of("0123456789");
  if (d + 1 >= path.size()) return -1;
  return std::stol(path.substr(d + 1));
}

// Where a driver container stages the user-space libraries, under the
// driver root (the order of utils/nvml.py DRIVER_LIBRARY_DIRS).
const char* const kDriverLibraryDirs[] = {
    "usr/lib/x86_64-linux-gnu", "usr/lib64", "lib/x86_64-linux-gnu",
    "lib64", "usr/lib", "lib"};

// `soname` in the first of kDriverLibraryDirs under `root` that holds it;
// "" when none does.
inline std::string FindDriverLibrary(const std::string& root,
                                     const std::string& soname) {
  std::string base = root.empty() || root.back() == '/' ? root : root + "/";
  for (const char* d : kDriverLibraryDirs) {
    std::string cand = base + d + "/" + soname;
    if (access(cand.c_str(), F_OK) == 0) return cand;
  }
  return "";
}

// The driver library an agent reads: `installDir`/libcuda.so.1 when an
// install dir is named (verbatim: a named location is never searched
// around), else the first staged copy under the driver root.
inline std::string LibcudaPath(const std::string& installDir,
                               const std::string& driverRoot) {
  if (!installDir.empty()) {
    std::string p = installDir + "/libcuda.so.1";
    return access(p.c_str(), F_OK) == 0 ? p : "";
  }
  return FindDriverLibrary(driverRoot, "libcuda.so.1");
}

struct DriverLibInfo {
  std::string path;
  bool loadable = false;
  bool driver_api = false;  // exports cuInit (the CUDA driver API)
};

inline DriverLibInfo ProbeDriverLibrary(const std::string& path) {
  DriverLibInfo info;
  info.path = path;
  if (path.empty()) return info;
  void* h = dlopen(path.c_str(), RTLD_LAZY | RTLD_LOCAL);
  if (h == nullptr) return info;
  info.loadable = true;
  info.driver_api = dlsym(h, "cuInit") != nullptr;
  dlclose(h);
  return info;
}

inline bool IsDigit(char c) { return c >= '0' && c <= '9'; }

// Match `<3 digits>.<1-3 digits>[.<1-3 digits>]` at `text[p]`, with the
// backtracking order of Python's re (greedy counts, the optional group
// tried first); `after(q)` accepts the position just past the match.
// Returns the epoch major*1e6 + minor*1e3 + patch, or -1.
template <typename After>
long long MatchVersionAt(const std::string& text, size_t p, After after) {
  auto digits = [&](size_t from, size_t n) {
    if (from + n > text.size()) return false;
    for (size_t i = from; i < from + n; ++i)
      if (!IsDigit(text[i])) return false;
    return true;
  };
  if (!digits(p, 3) || p + 3 >= text.size() || text[p + 3] != '.') return -1;
  long long major = std::stoll(text.substr(p, 3));
  size_t m0 = p + 4;
  for (size_t ml = 3; ml >= 1; --ml) {
    if (!digits(m0, ml)) continue;
    long long minor = std::stoll(text.substr(m0, ml));
    size_t q = m0 + ml;
    if (q < text.size() && text[q] == '.') {
      for (size_t pl = 3; pl >= 1; --pl) {
        if (digits(q + 1, pl) && after(q + 1 + pl)) {
          return major * 1000000 + minor * 1000 +
                 std::stoll(text.substr(q + 1, pl));
        }
      }
    }
    if (after(q)) return major * 1000000 + minor * 1000;
  }
  return -1;
}

// A comparable integer from the first driver version in `text`
// (550.54.15 → 550054015), -1 when there is none. Accepts EXACTLY what
// validator/driver_build.py VERSION_RE accepts — three digits not preceded
// by a digit, then one or two fields of one to three digits, not followed
// by a digit — so the agent never reports a skew the validator cannot
// corroborate.
inline long long DriverVersionEpoch(const std::string& text) {
  for (size_t p = 0; p + 4 < text.size(); ++p) {
    if (p > 0 && IsDigit(text[p - 1])) continue;
    long long e = MatchVersionAt(text, p, [&](size_t q) {
      return q >= text.size() || !IsDigit(text[q]);
    });
    if (e >= 0) return e;
  }
  return -1;
}

inline bool IsWordChar(char c) {
  return IsDigit(c) || c == '_' || (c >= 'A' && c <= 'Z') ||
         (c >= 'a' && c <= 'z');
}

// The version a staged driver library carries, as an epoch (-1 if none),
// by the rules of driver_build.extract_build: the name of the file the path
// resolves to (libcuda.so.580.159.03), else the first version string that
// stands as a C string of its own in the bytes ("\0580.159.03\0").
// Cached on (resolved path, mtime, size): the metrics agent calls this on
// every scrape, and the library is tens of MB.
inline long long StagedDriverEpoch(const std::string& path) {
  struct Cache {
    std::string path;
    long long mtime_ns = -1;
    long long size = -1;
    long long epoch = -1;
  };
  static Cache cache;  // agent scrapes are single-threaded (accept loop)
  char real[PATH_MAX];
  if (path.empty() || realpath(path.c_str(), real) == nullptr) return -1;
  struct stat st;
  if (::stat(real, &st) != 0) return -1;
  long long mtime_ns =
      static_cast<long long>(st.st_mtim.tv_sec) * 1000000000LL +
      st.st_mtim.tv_nsec;
  if (cache.path == real && cache.mtime_ns == mtime_ns &&
      cache.size == static_cast<long long>(st.st_size)) {
    return cache.epoch;
  }
  long long epoch = -1;
  // lib\w+\.so\.<version>, the whole name
  std::string name = real;
  name = name.substr(name.rfind('/') + 1);
  size_t so = name.find(".so.");
  bool word = so != std::string::npos && so > 3 && name.rfind("lib", 0) == 0;
  for (size_t i = 3; word && i < so; ++i) word = IsWordChar(name[i]);
  if (word) {
    epoch = MatchVersionAt(name, so + 4,
                           [&](size_t q) { return q == name.size(); });
  }
  if (epoch < 0) {
    std::ifstream f(real, std::ios::binary);
    const size_t kChunk = 4 << 20, kOverlap = 160;
    std::string buf(kChunk, '\0');
    std::string tail;
    while (f && epoch < 0) {
      f.read(&buf[0], static_cast<std::streamsize>(kChunk));
      std::streamsize n = f.gcount();
      if (n <= 0) break;
      std::string window = tail + buf.substr(0, static_cast<size_t>(n));
      for (size_t p = 0; p + 1 < window.size() && epoch < 0; ++p) {
        if (window[p] != '\0') continue;
        epoch = MatchVersionAt(window, p + 1, [&](size_t q) {
          return q < window.size() && window[q] == '\0';
        });
      }
      tail = window.size() > kOverlap ? window.substr(window.size() - kOverlap)
                                      : window;
    }
  }
  cache = {real, mtime_ns, static_cast<long long>(st.st_size), epoch};
  return epoch;
}

inline bool WriteFileAtomic(const std::string& path,
                            const std::string& content) {
  std::string tmp = path + ".tmp";
  {
    std::ofstream f(tmp, std::ios::trunc);
    if (!f) return false;
    f << content;
    if (!f.flush()) return false;
  }
  return ::rename(tmp.c_str(), path.c_str()) == 0;
}

inline bool ReadFile(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::ostringstream ss;
  ss << f.rdbuf();
  *out = ss.str();
  return true;
}

inline bool MkdirP(const std::string& path) {
  std::string cur;
  std::istringstream ss(path);
  std::string part;
  if (!path.empty() && path[0] == '/') cur = "/";
  while (std::getline(ss, part, '/')) {
    if (part.empty()) continue;
    cur += part + "/";
    if (mkdir(cur.c_str(), 0755) != 0 && errno != EEXIST) return false;
  }
  return true;
}

// Minimal JSON string escaping for the few strings we emit.
inline std::string JsonEscape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default: out += c;
    }
  }
  return out;
}

inline double NowSeconds() {
  struct timespec ts{};
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<double>(ts.tv_sec) + ts.tv_nsec * 1e-9;
}

// Worker-identity facts for multi-node jobs, merged from (1) the host env
// file the feature-discovery operand writes (KEY=VALUE lines) and (2) the
// agent's own environment, which wins. Only the variables the fabric
// validator and torch.distributed's env:// rendezvous read are consumed.
inline std::vector<std::pair<std::string, std::string>> WorkerIdentityEnv(
    const std::string& workerEnvFile) {
  auto relevant = [](const std::string& k) {
    return k == "WORKER_ID" || k == "WORKER_HOSTNAMES" ||
           k == "MASTER_ADDR" || k == "MASTER_PORT";
  };
  std::vector<std::pair<std::string, std::string>> out;
  // empty value = unset (lets the agent env override a staged fact away)
  auto upsert = [&out](const std::string& k, const std::string& v) {
    for (auto it = out.begin(); it != out.end(); ++it) {
      if (it->first == k) {
        if (v.empty()) out.erase(it);
        else it->second = v;
        return;
      }
    }
    if (!v.empty()) out.emplace_back(k, v);
  };
  std::string text;
  if (!workerEnvFile.empty() && ReadFile(workerEnvFile, &text)) {
    std::istringstream ss(text);
    std::string line;
    while (std::getline(ss, line)) {
      if (line.empty() || line[0] == '#') continue;
      size_t eq = line.find('=');
      if (eq == std::string::npos) continue;
      std::string k = line.substr(0, eq);
      if (relevant(k)) upsert(k, line.substr(eq + 1));
    }
  }
  for (char** e = environ; e != nullptr && *e != nullptr; ++e) {
    std::string kv = *e;
    size_t eq = kv.find('=');
    if (eq == std::string::npos) continue;
    std::string k = kv.substr(0, eq);
    if (relevant(k)) upsert(k, kv.substr(eq + 1));
  }
  return out;
}

// The env a workload container must receive on this host — the one list
// both injection paths (the CDI spec's containerEdits and the OCI
// createRuntime hook) materialize, so they cannot disagree. When multi-node
// jobs are on (MULTINODE_ENABLED=true from the operator), worker identity
// is appended, and the rendezvous address torch.distributed reads
// (MASTER_ADDR, MASTER_PORT) is synthesized from the first worker hostname
// when it is not set (MASTER_PORT 29500, torch.distributed's default).
inline std::vector<std::pair<std::string, std::string>> WorkloadEnv(
    const std::string& workerEnvFile) {
  std::vector<std::pair<std::string, std::string>> out = {
      {"GPU_RUNTIME_MANAGED", "gpu-operator"},
  };
  const char* mn = getenv("MULTINODE_ENABLED");
  if (mn == nullptr || std::string(mn) != "true") return out;
  out.emplace_back("MULTINODE_ENABLED", "true");
  std::string hostnames, addr, port;
  for (const auto& kv : WorkerIdentityEnv(workerEnvFile)) {
    if (kv.first == "WORKER_HOSTNAMES") hostnames = kv.second;
    if (kv.first == "MASTER_ADDR") addr = kv.second;
    if (kv.first == "MASTER_PORT") port = kv.second;
    out.push_back(kv);
  }
  if (addr.empty() && !hostnames.empty()) {
    out.emplace_back("MASTER_ADDR", hostnames.substr(0, hostnames.find(',')));
    if (port.empty()) out.emplace_back("MASTER_PORT", "29500");
  }
  return out;
}

}  // namespace gpuop
