// NVML, the NVIDIA driver's management library, by dlopen.
//
// No NVML header is used: the prototypes below are declared by hand from
// NVML's API reference, as tpu_operator_torch/utils/nvml.py declares them
// for ctypes, and this file reads the same facts under the same names:
// cards keyed by their minor number (the N of /dev/nvidiaN), attributes
// `index` (NVML's own), `name`, `nvlink_up`, `nvlink_down` and the error
// counters, and each card's UUID (the name the NVIDIA container toolkit
// reads beside NVML's index). Nothing here creates a CUDA context.
#pragma once

#include <dlfcn.h>

#include <map>
#include <set>
#include <string>
#include <utility>
#include <vector>

#include "util.h"

namespace gpuop {

constexpr char kNvmlSoname[] = "libnvidia-ml.so.1";

struct NvmlCard {
  unsigned minor = 0;
  std::string uuid;
  // attribute → value, in the order NvmlSource publishes them
  std::vector<std::pair<std::string, std::string>> attrs;
};

struct NvmlView {
  bool loaded = false;  // the library dlopens and exports NVML
  bool ok = false;      // every call answered (else no card is listed)
  std::string driverVersion;
  std::vector<NvmlCard> cards;

  // NVML's minor numbers, or nullptr-equivalent (`loaded` false) when the
  // library is absent: then presence falls back to permission bits.
  std::set<long> Minors() const {
    std::set<long> out;
    for (const auto& c : cards) out.insert(c.minor);
    return out;
  }
  const NvmlCard* Card(long minor) const {
    for (const auto& c : cards)
      if (static_cast<long>(c.minor) == minor) return &c;
    return nullptr;
  }
};

namespace nvml_detail {

constexpr int kSuccess = 0;
constexpr int kInvalidArgument = 2;
constexpr int kNotSupported = 3;
constexpr unsigned kMaxLinks = 18;
constexpr unsigned kNameBuffer = 96;
constexpr unsigned kUuidBuffer = 96;
constexpr unsigned kDriverVersionBuffer = 80;

using Handle = void*;
struct Api {
  int (*init)();
  int (*shutdown)();
  int (*count)(unsigned*);
  int (*handle)(unsigned, Handle*);
  int (*minorNumber)(Handle, unsigned*);
  int (*name)(Handle, char*, unsigned);
  int (*uuid)(Handle, char*, unsigned);
  int (*nvlinkState)(Handle, unsigned, int*);
  int (*eccErrors)(Handle, int, int, unsigned long long*);
  int (*remappedRows)(Handle, unsigned*, unsigned*, unsigned*, unsigned*);
  int (*driverVersion)(char*, unsigned);
};

inline bool Absent(int rc) {
  return rc == kNotSupported || rc == kInvalidArgument;
}

template <typename Fn>
bool Bind(void* h, const char* name, Fn* out) {
  *out = reinterpret_cast<Fn>(dlsym(h, name));
  return *out != nullptr;
}

}  // namespace nvml_detail

// One NVML session: every card's attributes, as NvmlSource._read_all reads
// them. `path` is dlopened as given; a library that does not load (or
// lacks NVML's symbols) gives loaded=false.
inline NvmlView ReadNvml(const std::string& path) {
  using namespace nvml_detail;
  NvmlView view;
  void* h = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (h == nullptr) return view;
  Api api{};
  bool bound = Bind(h, "nvmlInit_v2", &api.init) &&
               Bind(h, "nvmlShutdown", &api.shutdown) &&
               Bind(h, "nvmlDeviceGetCount_v2", &api.count) &&
               Bind(h, "nvmlDeviceGetHandleByIndex_v2", &api.handle) &&
               Bind(h, "nvmlDeviceGetMinorNumber", &api.minorNumber) &&
               Bind(h, "nvmlDeviceGetName", &api.name) &&
               Bind(h, "nvmlDeviceGetUUID", &api.uuid) &&
               Bind(h, "nvmlDeviceGetNvLinkState", &api.nvlinkState) &&
               Bind(h, "nvmlDeviceGetTotalEccErrors", &api.eccErrors) &&
               Bind(h, "nvmlDeviceGetRemappedRows", &api.remappedRows) &&
               Bind(h, "nvmlSystemGetDriverVersion", &api.driverVersion);
  if (!bound) {
    dlclose(h);
    return view;
  }
  view.loaded = true;
  // a call that fails lists no card: the driver NVML speaks for does not
  // answer
  auto fail = [&]() {
    view.cards.clear();
    return false;
  };
  auto readAll = [&]() {
    int rc = api.init();
    if (rc != kSuccess) return fail();
    char buf[kDriverVersionBuffer] = {0};
    rc = api.driverVersion(buf, sizeof(buf));
    if (rc != kSuccess) return fail();
    view.driverVersion = buf;
    unsigned n = 0;
    rc = api.count(&n);
    if (rc != kSuccess) return fail();
    for (unsigned i = 0; i < n; ++i) {
      Handle dev = nullptr;
      rc = api.handle(i, &dev);
      if (rc != kSuccess) return fail();
      NvmlCard card;
      char name[kNameBuffer] = {0};
      rc = api.name(dev, name, sizeof(name));
      if (rc != kSuccess) return fail();
      card.attrs = {{"index", std::to_string(i)}, {"name", name}};
      char uuid[kUuidBuffer] = {0};
      rc = api.uuid(dev, uuid, sizeof(uuid));
      if (rc != kSuccess) return fail();
      card.uuid = uuid;
      std::string down;
      bool anyLink = false;
      for (unsigned link = 0; link < kMaxLinks; ++link) {
        int on = 0;
        rc = api.nvlinkState(dev, link, &on);
        if (Absent(rc)) continue;
        if (rc != kSuccess) return fail();
        anyLink = true;
        if (on != 1) down += (down.empty() ? "" : ",") + std::to_string(link);
      }
      if (anyLink) {
        card.attrs.emplace_back("nvlink_up", down.empty() ? "1" : "0");
        if (!down.empty()) card.attrs.emplace_back("nvlink_down", down);
      }
      const char* eccNames[] = {"ecc_corrected_volatile",
                                "ecc_uncorrected_volatile"};
      for (int type = 0; type < 2; ++type) {
        unsigned long long v = 0;
        rc = api.eccErrors(dev, type, 0 /* volatile */, &v);
        if (Absent(rc)) break;
        if (rc != kSuccess) return fail();
        card.attrs.emplace_back(eccNames[type], std::to_string(v));
      }
      unsigned corr = 0, unc = 0, pending = 0, failure = 0;
      rc = api.remappedRows(dev, &corr, &unc, &pending, &failure);
      if (rc == kSuccess) {
        card.attrs.emplace_back("remapped_rows_pending",
                                std::to_string(pending));
        card.attrs.emplace_back("remapped_rows_failure",
                                std::to_string(failure));
      } else if (!Absent(rc)) {
        return fail();
      }
      rc = api.minorNumber(dev, &card.minor);
      if (rc != kSuccess) return fail();
      view.cards.push_back(card);
    }
    return true;
  };
  view.ok = readAll();
  api.shutdown();
  dlclose(h);
  return view;
}

// A card's device node and whether it counts as present: where NVML loads,
// when NVML lists the node's number; without NVML, when the node is
// readable and writable (the reference's rule). No node is ever opened: an
// open may initialise a card that is not in persistence mode. `uuid` is
// NVML's UUID of the card, empty without NVML.
struct GpuNode {
  std::string path;
  long number = -1;
  bool present = false;
  std::string uuid;
};

inline std::vector<GpuNode> ScanGpuNodes(const std::string& devGlob,
                                         const NvmlView& nvml) {
  std::set<long> listed = nvml.Minors();
  std::vector<GpuNode> out;
  for (const auto& path : FindGpuDevices(devGlob)) {
    GpuNode node;
    node.path = path;
    node.number = NodeNumber(path);
    node.present = nvml.loaded
                       ? listed.count(node.number) > 0
                       : access(path.c_str(), R_OK | W_OK) == 0;
    if (const NvmlCard* card = nvml.Card(node.number)) node.uuid = card->uuid;
    out.push_back(node);
  }
  return out;
}

inline std::vector<GpuNode> PresentGpuNodes(const std::string& devGlob,
                                            const std::string& nvmlPath) {
  std::vector<GpuNode> out;
  for (const auto& n : ScanGpuNodes(devGlob, ReadNvml(nvmlPath)))
    if (n.present) out.push_back(n);
  return out;
}

inline std::vector<std::string> PresentGpuDevices(
    const std::string& devGlob, const std::string& nvmlPath) {
  std::vector<std::string> out;
  for (const auto& n : PresentGpuNodes(devGlob, nvmlPath))
    out.push_back(n.path);
  return out;
}

}  // namespace gpuop
