"""Fake ``libcuda.so.1`` files for the port's validator tests.

A fake driver library is a copy of the system's libc, which ``dlopen``
loads, with a version string appended to its bytes. Every copy that is a
new file is a new shared object to the dynamic loader: it maps it again and
gives it another block of static TLS, of which a process has room for only
about ten. So the copies are made once per stamp per test process, under
pytest's base temporary directory, and each test's fixture tree gets a
hard link to one (same inode: the loader reuses the mapping it has).
``driver_build.extract_build`` caches on the resolved path, so each tree's
link is still read for its own stamp.

Import the ``libcuda_copies`` fixture into a test module to use it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import shutil
from pathlib import Path

import pytest

_copies: dict[tuple[str, str | None], Path] = {}


def system_libc() -> str:
    src = ctypes.CDLL(ctypes.util.find_library("c"))._name
    return src if os.path.isabs(src) else "/lib/x86_64-linux-gnu/libc.so.6"


def libc_copy(base: Path, stamp: str | None) -> Path:
    """The one libc copy under ``base`` stamped with ``stamp`` (None: the
    plain copy), made on first use in this process."""
    key = (str(base), stamp)
    if key not in _copies:
        libs = base / "fake-libcuda"
        libs.mkdir(exist_ok=True)
        path = libs / f"libc-{stamp or 'plain'}.so"
        shutil.copy(system_libc(), path)
        if stamp is not None:
            with open(path, "ab") as f:
                f.write(b"\0" + stamp.encode() + b"\0")
        _copies[key] = path
    return _copies[key]


class LibcudaCopies:
    def __init__(self, base: Path):
        self.base = base

    def link(self, target: Path, stamp: str | None = None) -> Path:
        """Hard-link the copy stamped with ``stamp`` at ``target``."""
        os.link(libc_copy(self.base, stamp), target)
        return target


@pytest.fixture(scope="session")
def libcuda_copies(tmp_path_factory) -> LibcudaCopies:
    return LibcudaCopies(tmp_path_factory.getbasetemp())
