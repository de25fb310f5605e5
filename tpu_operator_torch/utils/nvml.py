"""A ctypes binding of NVML, the NVIDIA driver's management library.

The GPU counterpart of the sysfs attribute files the reference's health
probes read (``/sys/class/accel/accel<N>/<attr>``): the NVIDIA driver
exposes link state and error counters through NVML, not sysfs. There are
no headers here, so the prototypes are declared by hand from NVML's API
reference.

Two layers:

- ``Library``: the ctypes calls, one method per NVML function; a return
  code other than success raises ``NvmlError``.
- ``NvmlSource``: one NVML session per call turned into per-device
  attribute dicts of strings, keyed by the card's minor number (the ``N``
  of ``/dev/nvidiaN``, which the health file and the annotations use;
  NVML's own index follows PCI order). ``uuids`` maps a minor number to
  the card's UUID, the name the device plugin hands the NVIDIA container
  toolkit. The tests drive it with a fake ``Library``.

A missing ``libnvidia-ml.so.1`` means the platform does not expose these
facts: ``NvmlSource`` then reports no devices, and the probes skip, as the
reference's do for a missing attribute. NVML talks to the driver, not to
CUDA: nothing here creates a CUDA context.
"""

from __future__ import annotations

import ctypes
import os

SONAME = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_INVALID_ARGUMENT = 2
NVML_ERROR_NOT_SUPPORTED = 3
NVML_NVLINK_MAX_LINKS = 18
NVML_DEVICE_NAME_V2_BUFFER_SIZE = 96
NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE = 80
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96
NVML_FEATURE_ENABLED = 1
NVML_MEMORY_ERROR_TYPE_CORRECTED = 0
NVML_MEMORY_ERROR_TYPE_UNCORRECTED = 1
NVML_VOLATILE_ECC = 0
#: ``nvmlGpuP2PCapsIndex_t``: the NVLink index of ``nvmlDeviceGetP2PStatus``
#: (nvml.h: READ 0, WRITE 1, NVLINK 2, ATOMICS 3, PROP 4)
NVML_P2P_CAPS_INDEX_NVLINK = 2
#: ``nvmlGpuP2PStatus_t``: the pair can talk by that capability
NVML_P2P_STATUS_OK = 0

#: the error counters ``NvmlSource`` reports (NVML has no Xid counter:
#: Xids arrive only as events)
COUNTERS = ("ecc_corrected_volatile", "ecc_uncorrected_volatile",
            "remapped_rows_pending", "remapped_rows_failure")

#: where a driver container stages the user-space libraries, under the
#: driver root
DRIVER_LIBRARY_DIRS = ("usr/lib/x86_64-linux-gnu", "usr/lib64",
                       "lib/x86_64-linux-gnu", "lib64", "usr/lib", "lib")


def find_driver_library(root: str, soname: str) -> str | None:
    """``soname`` in the first of ``DRIVER_LIBRARY_DIRS`` under ``root``
    that holds it."""
    for d in DRIVER_LIBRARY_DIRS:
        cand = os.path.join(root, d, soname)
        if os.path.exists(cand):
            return cand
    return None


class NvmlError(RuntimeError):
    def __init__(self, function: str, code: int, text: str = ""):
        super().__init__(f"{function} returned {code}"
                         + (f" ({text})" if text else ""))
        self.function = function
        self.code = code


_uint = ctypes.c_uint
_handle = ctypes.c_void_p          # nvmlDevice_t: an opaque pointer
_PROTOTYPES = {
    "nvmlInit_v2": (),
    "nvmlShutdown": (),
    "nvmlDeviceGetCount_v2": (ctypes.POINTER(_uint),),
    "nvmlDeviceGetHandleByIndex_v2": (_uint, ctypes.POINTER(_handle)),
    "nvmlDeviceGetMinorNumber": (_handle, ctypes.POINTER(_uint)),
    "nvmlDeviceGetName": (_handle, ctypes.c_char_p, _uint),
    "nvmlDeviceGetUUID": (_handle, ctypes.c_char_p, _uint),
    # nvmlEnableState_t is a C enum: an int
    "nvmlDeviceGetNvLinkState": (_handle, _uint,
                                 ctypes.POINTER(ctypes.c_int)),
    "nvmlDeviceGetTotalEccErrors": (_handle, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_ulonglong)),
    "nvmlDeviceGetRemappedRows": (_handle, ctypes.POINTER(_uint),
                                  ctypes.POINTER(_uint),
                                  ctypes.POINTER(_uint),
                                  ctypes.POINTER(_uint)),
    "nvmlSystemGetDriverVersion": (ctypes.c_char_p, _uint),
    # nvmlGpuP2PCapsIndex_t and nvmlGpuP2PStatus_t are C enums: ints
    "nvmlDeviceGetP2PStatus": (_handle, _handle, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)),
}


class Library:
    """NVML's functions over ``dlopen(path)``. Raises ``OSError`` when the
    library cannot be loaded."""

    def __init__(self, path: str = SONAME):
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _PROTOTYPES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int          # nvmlReturn_t
        self._lib.nvmlErrorString.argtypes = [ctypes.c_int]
        self._lib.nvmlErrorString.restype = ctypes.c_char_p

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != NVML_SUCCESS:
            text = self._lib.nvmlErrorString(rc) or b""
            raise NvmlError(name, rc, text.decode(errors="replace"))

    def init(self) -> None:
        self._call("nvmlInit_v2")

    def shutdown(self) -> None:
        self._call("nvmlShutdown")

    def device_count(self) -> int:
        n = _uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int):
        h = _handle()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def minor_number(self, handle) -> int:
        n = _uint()
        self._call("nvmlDeviceGetMinorNumber", handle, ctypes.byref(n))
        return n.value

    def name(self, handle) -> str:
        buf = ctypes.create_string_buffer(NVML_DEVICE_NAME_V2_BUFFER_SIZE)
        self._call("nvmlDeviceGetName", handle, buf, len(buf))
        return buf.value.decode(errors="replace")

    def uuid(self, handle) -> str:
        """The card's UUID (``GPU-…``): the name the NVIDIA container
        toolkit reads in ``NVIDIA_VISIBLE_DEVICES`` and in a CDI device
        name beside NVML's index."""
        buf = ctypes.create_string_buffer(NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        self._call("nvmlDeviceGetUUID", handle, buf, len(buf))
        return buf.value.decode(errors="replace")

    def nvlink_state(self, handle, link: int) -> bool:
        state = ctypes.c_int()
        self._call("nvmlDeviceGetNvLinkState", handle, link,
                   ctypes.byref(state))
        return state.value == NVML_FEATURE_ENABLED

    def total_ecc_errors(self, handle, error_type: int,
                         counter_type: int = NVML_VOLATILE_ECC) -> int:
        n = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEccErrors", handle, error_type,
                   counter_type, ctypes.byref(n))
        return n.value

    def remapped_rows(self, handle) -> tuple[int, int, int, int]:
        """(correctable rows, uncorrectable rows, remap pending, remap
        failure occurred)."""
        vals = [_uint() for _ in range(4)]
        self._call("nvmlDeviceGetRemappedRows", handle,
                   *(ctypes.byref(v) for v in vals))
        return tuple(v.value for v in vals)

    def driver_version(self) -> str:
        buf = ctypes.create_string_buffer(
            NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE)
        self._call("nvmlSystemGetDriverVersion", buf, len(buf))
        return buf.value.decode(errors="replace")

    def p2p_nvlink(self, h1, h2) -> bool:
        """Whether the two cards can reach each other over NVLink."""
        status = ctypes.c_int()
        self._call("nvmlDeviceGetP2PStatus", h1, h2,
                   NVML_P2P_CAPS_INDEX_NVLINK, ctypes.byref(status))
        return status.value == NVML_P2P_STATUS_OK


def _absent(e: NvmlError) -> bool:
    """The codes by which NVML says a device lacks a feature."""
    return e.code in (NVML_ERROR_NOT_SUPPORTED, NVML_ERROR_INVALID_ARGUMENT)


class NvmlSource:
    """Per-device attributes from NVML. ``library`` is a ``Library`` or a
    stand-in with its methods; by default ``Library()`` is loaded on first
    use, and a library that does not load gives no devices."""

    def __init__(self, library=None):
        self._library = library

    def library(self):
        if self._library is None:
            try:
                self._library = Library()
            except OSError:
                return None
        return self._library

    def _session(self, fn):
        lib = self.library()
        if lib is None:
            return None
        lib.init()
        try:
            return fn(lib)
        finally:
            lib.shutdown()

    def attributes(self) -> dict[int, dict[str, str]]:
        """{minor number: {attribute: value}}: ``index`` (NVML's), ``name``,
        ``nvlink_up`` ("1" when every link the card has is active, "0"
        otherwise; absent without NVLink), ``nvlink_down`` (the inactive
        links, comma-separated; only when there are some) and the
        ``COUNTERS`` the card supports."""
        return self._session(self._read_all) or {}

    def driver_version(self) -> str | None:
        return self._session(lambda lib: lib.driver_version())

    def minor_numbers(self) -> set[int] | None:
        """The minor numbers of the cards NVML lists; None where NVML does
        not load. An NVML that loads but fails lists no card: the driver
        it speaks for does not answer."""
        if self.library() is None:
            return None
        try:
            return self._session(lambda lib: {
                lib.minor_number(lib.handle(i))
                for i in range(lib.device_count())})
        except NvmlError:
            return set()

    def uuids(self) -> dict[int, str] | None:
        """{minor number: UUID} for every card NVML lists; None where NVML
        does not load, and no card where it loads but fails."""
        if self.library() is None:
            return None
        try:
            return self._session(lambda lib: {
                lib.minor_number(h): lib.uuid(h) for h in
                (lib.handle(i) for i in range(lib.device_count()))})
        except NvmlError:
            return {}

    def nvlink_peers(self) -> dict[int, set[int]] | None:
        """{minor number: the minor numbers it reaches over NVLink} for
        every card NVML lists; None where NVML does not load. A pair whose
        status query fails counts as not linked."""
        if self.library() is None:
            return None

        def read(lib):
            cards = [(lib.minor_number(h), h) for h in
                     (lib.handle(i) for i in range(lib.device_count()))]
            peers: dict[int, set[int]] = {m: set() for m, _ in cards}
            for i, (m1, h1) in enumerate(cards):
                for m2, h2 in cards[i + 1:]:
                    try:
                        linked = lib.p2p_nvlink(h1, h2)
                    except NvmlError:
                        linked = False
                    if linked:
                        peers[m1].add(m2)
                        peers[m2].add(m1)
            return peers
        try:
            return self._session(read)
        except NvmlError:
            return {}

    def where(self, index: int, attr: str) -> str:
        return f"nvml:nvidia{index}/{attr}"

    @staticmethod
    def _read_all(lib) -> dict[int, dict[str, str]]:
        out = {}
        for i in range(lib.device_count()):
            h = lib.handle(i)
            attrs = {"index": str(i), "name": lib.name(h)}
            links = {}
            for link in range(NVML_NVLINK_MAX_LINKS):
                try:
                    links[link] = lib.nvlink_state(h, link)
                except NvmlError as e:
                    if not _absent(e):
                        raise
            if links:
                down = [str(k) for k, up in links.items() if not up]
                attrs["nvlink_up"] = "0" if down else "1"
                if down:
                    attrs["nvlink_down"] = ",".join(down)
            try:
                attrs["ecc_corrected_volatile"] = str(lib.total_ecc_errors(
                    h, NVML_MEMORY_ERROR_TYPE_CORRECTED))
                attrs["ecc_uncorrected_volatile"] = str(lib.total_ecc_errors(
                    h, NVML_MEMORY_ERROR_TYPE_UNCORRECTED))
            except NvmlError as e:
                if not _absent(e):
                    raise
            try:
                _, _, pending, failure = lib.remapped_rows(h)
                attrs["remapped_rows_pending"] = str(pending)
                attrs["remapped_rows_failure"] = str(failure)
            except NvmlError as e:
                if not _absent(e):
                    raise
            out[lib.minor_number(h)] = attrs
        return out


class FileSource:
    """Per-device attributes from files, in the reference's sysfs layout
    with NVIDIA's device names: ``<root>/nvidia<N>/<attr>`` holding the
    value. A root that does not exist gives no devices."""

    def __init__(self, root: str):
        self.root = root

    def attributes(self) -> dict[int, dict[str, str]]:
        out = {}
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            return out
        for e in entries:
            if not e.startswith("nvidia") or not e[6:].isdigit():
                continue
            try:
                names = sorted(os.listdir(os.path.join(self.root, e)))
            except OSError:
                continue
            attrs = {}
            for name in names:
                try:
                    with open(os.path.join(self.root, e, name)) as f:
                        attrs[name] = f.read()
                except OSError:
                    continue
            out[int(e[6:])] = attrs
        return out

    def where(self, index: int, attr: str) -> str:
        return os.path.join(self.root, f"nvidia{index}", attr)
