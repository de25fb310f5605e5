"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and traffic, and the metrics; each piece is a file of its
own under ``port_bench/``, found by that name.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that is not there."""


def _name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"not a name: {name!r}")
    return name


class Pieces:
    """The pieces under one checkout: ``BENCHMARK.json`` at ``root`` and
    the files under ``root/port_bench``."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "port_bench"

    def benchmark(self) -> dict:
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise SpecError(f"no {path}")
        return json.loads(path.read_text())

    def config(self, bench: dict, name: str) -> dict:
        for entry in bench.get("configs", []):
            if entry.get("name") == _name(name):
                return json.loads((self.root / entry["file"]).read_text())
        raise SpecError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.dir / "traffic" / f"{_name(name)}.json"
        if not path.is_file():
            raise SpecError(f"no traffic mix {path}")
        return json.loads(path.read_text())

    def module(self, kind: str, name: str):
        """``port_bench/<kind>/<name>.py`` loaded as a module (a metric's
        name may hold dots, so it is loaded by its path)."""
        path = self.dir / kind / f"{_name(name)}.py"
        if not path.is_file():
            raise SpecError(f"no {kind[:-1]} {path}")
        spec = importlib.util.spec_from_file_location(
            f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def cell(bench: dict, name: str) -> dict:
    for entry in bench.get("workloads", []):
        if entry.get("name") == _name(name):
            return entry
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's per-layer metrics when ``trace``, else its end-to-end
    ones: each that lists the cell, or lists no cells."""
    group = bench.get("per_layer" if trace else "end_to_end", [])
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]
