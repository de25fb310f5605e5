"""NVIDIA driver version extraction: the version-skew detector's foundation.

The GPU form of ``tpu_operator/validator/libtpu_build.py``. A node's driver
has two halves that must be of one version: the user-space library
``libcuda.so.1`` (a link to ``libcuda.so.<version>``), which the driver
container stages, and the kernel module, which reports its version in
``/proc/driver/nvidia/version``::

    NVRM version: NVIDIA UNIX x86_64 Kernel Module  550.54.15  Tue Mar  5 ...

When the two differ, a driver upgrade is half done: the new library is
staged while the old module is still loaded, and every CUDA program on the
node fails with "Driver/library version mismatch". The validator must catch
that before workloads do, and the upgrade must not uncordon a node in that
state.

As in the reference, the running side is recorded by the workload
validation (which has just run on the card) into the validations directory,
and read by the driver component and the metrics agent; the record is a
one-shot witness that a consumer deletes on a mismatch.
"""

from __future__ import annotations

import os
import re
import tempfile

# a driver version: 550.54.15, or 535.104 (three digits, then one or two
# fields)
VERSION_RE = re.compile(rb"(?<!\d)(\d{3})\.(\d{1,3})(?:\.(\d{1,3}))?(?!\d)")
# the version as a C string of its own in the library's bytes
_STAMP_RE = re.compile(rb"\x00(\d{3}\.\d{1,3}(?:\.\d{1,3})?)\x00")
# the kernel module's line in /proc/driver/nvidia/version
_NVRM_RE = re.compile(r"^NVRM version:.*Kernel Module.*$", re.MULTILINE)

_CHUNK = 4 << 20
# a stamp spans well under 32 bytes; overlap chunk reads by more than that
# so a match straddling a chunk boundary is still seen
_OVERLAP = 160

# (path, mtime_ns, size) → version; the library is tens of MB and callers
# re-check on periodic loops (metrics-mode revalidation every 60 s), so a
# full rescan is only paid when the file actually changed
_extract_cache: dict[tuple, str | None] = {}


def extract_build(path: str) -> str | None:
    """The driver version of the library at ``path``: from the name of the
    file it resolves to (``libcuda.so.550.54.15``), else from a version
    string in its bytes; None when absent or unreadable. Cached on
    (resolved path, mtime, size)."""
    real = os.path.realpath(path)
    try:
        st = os.stat(real)
    except OSError:
        return None
    key = (real, st.st_mtime_ns, st.st_size)
    if key in _extract_cache:
        return _extract_cache[key]
    name = re.fullmatch(r"lib\w+\.so\.(\d{3}\.\d{1,3}(?:\.\d{1,3})?)",
                        os.path.basename(real))
    version = name.group(1) if name else None
    if version is None:
        try:
            with open(real, "rb") as f:
                tail = b""
                while True:
                    chunk = f.read(_CHUNK)
                    if not chunk:
                        break
                    m = _STAMP_RE.search(tail + chunk)
                    if m:
                        version = m.group(1).decode("ascii")
                        break
                    tail = chunk[-_OVERLAP:]
        except OSError:
            return None
    _extract_cache.clear()   # one driver per node: keep a single entry
    _extract_cache[key] = version
    return version


def build_epoch(text) -> int | None:
    """A comparable integer from the first driver version in ``text`` (an
    extracted version, the kernel module's line, or a recorded runtime
    build): 550.54.15 → 550054015."""
    if text is None:
        return None
    if isinstance(text, str):
        text = text.encode("utf-8", "replace")
    m = VERSION_RE.search(text)
    if m is None:
        return None
    major, minor, patch = m.groups()
    return int(major) * 1_000_000 + int(minor) * 1_000 + int(patch or 0)


def kernel_module_version(root: str = "/") -> str | None:
    """The ``NVRM version: ... Kernel Module ...`` line of
    ``<root>/proc/driver/nvidia/version``: the loaded kernel module, the
    running side of the pairing; None when there is none."""
    try:
        with open(os.path.join(root, "proc/driver/nvidia/version")) as f:
            m = _NVRM_RE.search(f.read())
    except OSError:
        return None
    return m.group(0) if m else None


def runtime_build_file(validations_dir: str) -> str:
    """Where the node records the RUNNING kernel module's version: written
    by workload validation (which has just run on the card), read by the
    driver component and the metrics agent. Lives in the validations
    hostPath both DaemonSets already share."""
    return os.environ.get(
        "GPU_RUNTIME_BUILD_FILE",
        os.path.join(validations_dir, "runtime-build"))


def record_runtime_build(validations_dir: str, module_version: str) -> bool:
    """Atomically persist the kernel module's version line. Returns False on
    any filesystem failure (missing dir, disk full) so the caller can log
    it — a believed-but-absent record would later read as a stale one.
    Never raises: recording is an observability side effect and must not
    crash validation outside its ValidationFailed protocol."""
    path = runtime_build_file(validations_dir)
    d = os.path.dirname(path) or "."
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".runtime-build.")
        with os.fdopen(fd, "w") as f:
            f.write(module_version)
        os.replace(tmp, path)
        return True
    except OSError:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


def consume_runtime_build(validations_dir: str) -> None:
    """Delete the record: it is a one-shot witness. A reader that finds it
    inconsistent with the staged library cannot know whether the MODULE or
    the RECORD is stale — consuming it forces the next workload validation
    to re-establish the truth instead of the stale record wedging every
    subsequent comparison."""
    try:
        os.unlink(runtime_build_file(validations_dir))
    except OSError:
        pass


def read_runtime_build(validations_dir: str) -> str | None:
    try:
        with open(runtime_build_file(validations_dir)) as f:
            return f.read()
    except OSError:
        return None
