"""Stand-ins for NVML in the port's tests.

``FakeLibrary`` has the methods of ``tpu_operator_torch.utils.nvml.Library``
over a list of device descriptions, for driving ``NvmlSource``.
``nvml_so`` (a session fixture) compiles a small C library that exports
NVML's functions with fixed answers, so that ``Library``'s ctypes
prototypes run on a machine without the NVIDIA driver; it skips where
there is no C compiler.
"""

from __future__ import annotations

import shutil
import subprocess

import pytest

from tpu_operator_torch.utils import nvml

NOT_SUPPORTED = nvml.NVML_ERROR_NOT_SUPPORTED
INVALID_ARGUMENT = nvml.NVML_ERROR_INVALID_ARGUMENT
GPU_IS_LOST = 15


def device(minor, name="NVIDIA H100 80GB HBM3", links=None, ecc=(0, 0),
           remapped=(0, 0, 0, 0), p2p=None):
    """One card: ``links`` maps a link number to True/False (up/down) or an
    NVML error code; links not named answer NOT_SUPPORTED. ``ecc`` is
    (corrected, uncorrected) or an error code, ``remapped`` the four values
    of ``nvmlDeviceGetRemappedRows`` or an error code. ``p2p`` maps a peer's
    minor number to True/False (NVLink P2P status OK or not) or an NVML
    error code; peers not named answer not linked."""
    return {"minor": minor, "name": name, "links": dict(links or {}),
            "ecc": ecc, "remapped": remapped, "p2p": dict(p2p or {})}


def nvlink_cards(minors, pairs):
    """Cards with these minor numbers, NVLink P2P capable exactly on the
    given (minor, minor) pairs, both ways."""
    p2p = {m: {} for m in minors}
    for a, b in pairs:
        p2p[a][b] = p2p[b][a] = True
    return [device(m, p2p=p2p[m]) for m in minors]


class FakeLibrary:
    def __init__(self, devices, driver="580.159.03"):
        self.devices = devices
        self.driver = driver
        self.open = False

    def _check(self, fn, value):
        if isinstance(value, int) and not isinstance(value, bool):
            raise nvml.NvmlError(fn, value)
        return value

    def init(self):
        self.open = True

    def shutdown(self):
        assert self.open
        self.open = False

    def device_count(self):
        assert self.open
        return len(self.devices)

    def handle(self, index):
        return index

    def minor_number(self, h):
        return self.devices[h]["minor"]

    def name(self, h):
        return self.devices[h]["name"]

    def nvlink_state(self, h, link):
        return self._check("nvmlDeviceGetNvLinkState",
                           self.devices[h]["links"].get(link, NOT_SUPPORTED))

    def total_ecc_errors(self, h, error_type, counter_type=0):
        assert counter_type == nvml.NVML_VOLATILE_ECC
        return self._check("nvmlDeviceGetTotalEccErrors",
                           self.devices[h]["ecc"])[error_type]

    def remapped_rows(self, h):
        return self._check("nvmlDeviceGetRemappedRows",
                           self.devices[h]["remapped"])

    def driver_version(self):
        return self.driver

    def p2p_nvlink(self, h1, h2):
        peer = self.devices[h2]["minor"]
        return self._check("nvmlDeviceGetP2PStatus",
                           self.devices[h1]["p2p"].get(peer, False))


# Two cards: NVML index 0 is minor 0, index 1 is minor 2. Links 0-3 exist
# (link 2 of the second card is down); past them the first card answers
# NOT_SUPPORTED and the second INVALID_ARGUMENT. The first card reports
# no remapped rows (NOT_SUPPORTED). The two cards are NVLink peers; a card
# asked about itself answers INVALID_ARGUMENT.
FAKE_NVML_C = r"""
#include <string.h>
typedef void *dev_t_;
static int count = 2;
int nvmlInit_v2(void) { return 0; }
int nvmlShutdown(void) { return 0; }
const char *nvmlErrorString(int rc) { return rc == 2 ? "Invalid Argument"
                                                     : "Not Supported"; }
int nvmlDeviceGetCount_v2(unsigned *n) { *n = count; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, dev_t_ *h) {
    if (i >= (unsigned)count) return 2;
    *h = (dev_t_)(unsigned long)(i + 1); return 0; }
static unsigned idx(dev_t_ h) { return (unsigned)(unsigned long)h - 1; }
int nvmlDeviceGetMinorNumber(dev_t_ h, unsigned *m) {
    *m = 2 * idx(h); return 0; }
int nvmlDeviceGetName(dev_t_ h, char *buf, unsigned len) {
    strncpy(buf, "NVIDIA H100 80GB HBM3", len); return 0; }
int nvmlDeviceGetNvLinkState(dev_t_ h, unsigned link, int *on) {
    if (link >= 4) return idx(h) == 0 ? 3 : 2;
    *on = !(idx(h) == 1 && link == 2); return 0; }
int nvmlDeviceGetTotalEccErrors(dev_t_ h, int type, int counter,
                                unsigned long long *n) {
    if (counter != 0) return 2;
    *n = type == 0 ? 5 + idx(h) : 7000000000ULL * idx(h); return 0; }
int nvmlDeviceGetRemappedRows(dev_t_ h, unsigned *c, unsigned *u,
                              unsigned *p, unsigned *f) {
    if (idx(h) == 0) return 3;
    *c = 1; *u = 2; *p = 1; *f = 0; return 0; }
int nvmlSystemGetDriverVersion(char *buf, unsigned len) {
    strncpy(buf, "580.159.03", len); return 0; }
int nvmlDeviceGetP2PStatus(dev_t_ a, dev_t_ b, int caps, int *status) {
    if (a == b || caps != 2) return 2;
    *status = 0; return 0; }
"""

#: what ``NvmlSource.nvlink_peers`` must read from the compiled library
FAKE_NVML_PEERS = {0: {2}, 2: {0}}

#: what ``NvmlSource`` must read from the compiled library
FAKE_NVML_ATTRIBUTES = {
    0: {"index": "0", "name": "NVIDIA H100 80GB HBM3", "nvlink_up": "1",
        "ecc_corrected_volatile": "5", "ecc_uncorrected_volatile": "0"},
    2: {"index": "1", "name": "NVIDIA H100 80GB HBM3", "nvlink_up": "0",
        "nvlink_down": "2", "ecc_corrected_volatile": "6",
        "ecc_uncorrected_volatile": "7000000000",
        "remapped_rows_pending": "1", "remapped_rows_failure": "0"},
}


def compile_c(d, name: str, source: str) -> str:
    """Build ``source`` into the shared library ``d/name``; skip the test
    where there is no C compiler."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a C compiler to build a stand-in library")
    (d / f"{name}.c").write_text(source)
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(d / name),
                    str(d / f"{name}.c")], check=True, capture_output=True)
    return str(d / name)


@pytest.fixture(scope="session")
def nvml_so(tmp_path_factory):
    return compile_c(tmp_path_factory.mktemp("fake-nvml"),
                     "libnvidia-ml.so.1", FAKE_NVML_C)
