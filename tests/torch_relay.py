"""Run the reference's relay tests on both copies and compare what they see.

A scenario of the relay tier is one test function of the reference's
relay test files (``tests/test_relay.py`` … ``tests/test_sessions.py``,
``tests/test_router.py``, ``tests/test_federation.py``), written once,
against ``tpu_operator``. ``run_case`` compiles that file
twice:

- the reference's side: the file as it stands;
- the port's side: its imports taken from ``tpu_operator_torch``
  (``TPUClusterPolicy`` is ``GPUClusterPolicy``), and every string in it
  through ``torch_names.to_port`` with ``torch_sides.NODE_MAP``, as
  ``torch_sides.Side.tr`` maps a scenario's inputs, then through ``PATHS``
  (the reference's package paths are the port's).

A file with names of its own beyond these (the analyzer's,
``tests/torch_analysis.py``) passes ``maps``: pairs applied before the
name map and after it, to its strings and to the reference's record.

In both, every ``assert`` also records the values it compares (each
operand of a comparison, else the asserted value), in a canonical JSON
form. The test runs on each side with fixtures of its own (``tmp_path``
and ``monkeypatch`` per side, the file's own fixtures called per side);
the reference's record goes through the same name map; the two records
must be equal entry for entry, and the assertions must hold on the port
as they do on the reference. So a scenario passes when the port computes
exactly what the reference computes at every point the reference's test
looks.

One difference is not a name: the device-kind table. The port's kinds are
``h100`` (its default) and ``a100``; the reference's are TPU generations,
and its default kind ``"tpu"`` is no kind of its table. While the
reference's side runs, its table holds the port's two models, its default
kind is ``h100`` and ``RelayService`` and ``BucketedCompileCache`` default
and ``RelayRouter`` default
to ``device_kind="h100"`` (``same_kinds``), so both sides price every
byte with the same model and hash the same kind into every executable
and routing key. The reference's own table is held by its own tests;
``tests/test_torch_relay_port.py`` holds the port's.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import enum
import hashlib
import importlib
import inspect
import io
import json
import logging
import os
import re
import sys
from collections import deque

import pytest

from torch_names import to_port
from torch_sides import NODE_MAP

TESTS = os.path.dirname(os.path.abspath(__file__))

#: the reference's relay test files
FILES = ("test_relay", "test_serving", "test_reqtrace", "test_arena",
         "test_qos", "test_pump", "test_utilization", "test_spmd",
         "test_sessions", "test_router", "test_federation")

#: scenarios that go through a module that is still to be ported: they
#: wait for it (none do)
WAITING: set = set()

#: the relay half of ``tests/test_reshard.py`` (its controller half is
#: ``tests/test_torch_reshard.py``'s): the compile cache's generations, the
#: plan watcher, the working set's projection, the service's cutover and
#: the router's (``RESHARD_ROUTER``)
RESHARD_RELAY = (
    "test_cache_spill_paths_are_generation_namespaced",
    "test_cache_eviction_spills_under_the_entrys_generation",
    "test_cache_stale_same_key_hit_is_a_miss",
    "test_cache_readmit_rejects_stale_generation_blob",
    "test_cache_retire_stale_drops_without_spilling",
    "test_shard_working_set_divides_batch_and_feature_dims",
    "test_plan_watcher_fires_once_per_new_generation",
    "test_plan_watcher_tolerates_torn_or_garbage_doc",
    "test_plan_watcher_tolerates_unlink_race",
    "test_plan_watcher_open_race_retries_the_glimpsed_plan",
    "test_service_reshard_prewarm_then_retire",
)
RESHARD_ROUTER = (
    "test_router_reshard_active_holds_then_lifts_with_pumps",
    "test_router_reshard_compiles_each_new_key_once_tierwide",
    "test_autoscaler_holds_during_active_reshard",
)
#: and the wiring pass over the resharding chain, which runs the analyzer
RESHARD_WIRING = ("test_wiring_pass_covers_resharding_chain",)

#: scenarios about the reference's TPU kind table or its default kind
#: ``"tpu"``; the port's counterparts are in tests/test_torch_relay_port.py
TRANSLATED = {
    "test_utilization.py::test_registry_v5_lite_is_bench_calibrated",
    "test_utilization.py::"
    "test_kind_model_unknown_kind_falls_back_to_default_params",
    "test_utilization.py::"
    "test_kind_model_overrides_apply_and_bad_values_are_ignored",
    "test_utilization.py::test_cli_build_utilization_reads_env",
    "test_router.py::test_routing_key_buckets_shapes_like_the_compile_cache",
}

#: scenarios whose assertions must hold on the port but whose records
#: differ by design: the CRD text is the API's, whose own parity test
#: (tests/test_torch_api.py) maps its GPU fields and header
ASSERTIONS_ONLY = {"test_qos.py::test_crd_schema_includes_qos_block"}

RENAMES = {"TPUClusterPolicy": "GPUClusterPolicy"}

#: the reference's package paths → the port's, applied after the name map
PATHS = ((r"\btpu_operator/", "tpu_operator_torch/"),)


def _subs(text: str, pairs) -> str:
    for pat, repl in pairs:
        text = re.sub(pat, repl, text)
    return text


def port_string(text: str, maps=((), ())) -> str:
    """A string of a reference test file, or of its record, in the
    port's names."""
    pre, post = maps
    return _subs(to_port(text, (*pre, *NODE_MAP)), (*PATHS, *post))


# -- the two compiled copies of a test file -----------------------------------

class _Record(ast.NodeTransformer):
    """Every ``assert`` records the values it compares through ``_rec``;
    ``@pytest.fixture`` decorators go (``run_case`` calls fixtures)."""

    def __init__(self):
        self.fixtures = set()

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        kept = []
        for d in node.decorator_list:
            src = ast.unparse(d)
            if src.startswith("pytest.fixture"):
                self.fixtures.add(node.name)
            else:
                kept.append(d)
        node.decorator_list = kept
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)

        def rec(e):
            return ast.Call(ast.Name("_rec", ast.Load()), [e], [])
        t = node.test
        if isinstance(t, ast.Compare):
            t.left = rec(t.left)
            t.comparators = [rec(c) for c in t.comparators]
        else:
            node.test = rec(t)
        return node


class _ToPort(ast.NodeTransformer):
    """The port's side of a test file: imports from the port, strings in
    the port's names."""

    def __init__(self, maps):
        self.maps = maps

    def visit_ImportFrom(self, node):
        if node.level or not (node.module == "tpu_operator"
                              or node.module.startswith("tpu_operator.")):
            return node
        module = "tpu_operator_torch" + node.module[len("tpu_operator"):]
        return [ast.Assign(
            [ast.Name(a.asname or RENAMES.get(a.name, a.name), ast.Store())],
            ast.Call(ast.Name("_imp", ast.Load()),
                     [ast.Constant(module),
                      ast.Constant(RENAMES.get(a.name, a.name))], []))
            for a in node.names]

    def visit_Name(self, node):
        node.id = RENAMES.get(node.id, node.id)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = port_string(node.value, self.maps)
        return node


class NotPorted(Exception):
    pass


class _Missing:
    """A name the port does not have (yet): any use raises."""

    def __init__(self, where):
        self.where = where

    def __getattr__(self, attr):
        raise NotPorted(self.where)

    def __call__(self, *a, **kw):
        raise NotPorted(self.where)


def _imp(module, name):
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError:
        return _Missing(module)
    if hasattr(mod, name):
        return getattr(mod, name)
    try:
        return importlib.import_module(f"{module}.{name}")
    except ImportError:
        return _Missing(f"{module}.{name}")


class Copy:
    """One side's compiled copy of a reference test file."""

    def __init__(self, name: str, side: str, maps=((), ())):
        path = os.path.join(TESTS, f"{name}.py")
        tree = ast.parse(open(path).read(), path)
        rec = _Record()
        tree = rec.visit(tree)
        if side == "p":
            tree = _ToPort(maps).visit(tree)
        ast.fix_missing_locations(tree)
        self.fixtures = rec.fixtures
        self.log: list = []
        self.ns = {"__name__": f"relay_{side}_{name}", "__file__": path,
                   "_rec": self._rec, "_imp": _imp}
        exec(compile(tree, path, "exec"), self.ns)
        self.ns["pytest"] = _Pytest(self)
        if side == "p" and "ASSETS" in self.ns:
            # the reference's assets are at the root, the port's in its
            # package
            self.ns["ASSETS"] = os.path.join(os.path.dirname(TESTS),
                                             "tpu_operator_torch", "assets")

    def _rec(self, value):
        self.log.append(canon(value))
        return value


class _Pytest:
    """``pytest`` in a copy: ``pytest.raises`` also records the exception
    it caught (its type and message)."""

    def __init__(self, copy):
        self._copy = copy

    def __getattr__(self, attr):
        return getattr(pytest, attr)

    @contextlib.contextmanager
    def raises(self, *a, **kw):
        with pytest.raises(*a, **kw) as info:
            yield info
        self._copy._rec(info.value)


class _Caplog(logging.Handler):
    """What the reference's tests use of pytest's ``caplog``:
    ``at_level`` and ``records``."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    @contextlib.contextmanager
    def at_level(self, level, logger=None):
        log = logging.getLogger(logger)
        saved = log.level
        log.setLevel(level)
        log.addHandler(self)
        try:
            yield
        finally:
            log.removeHandler(self)
            log.setLevel(saved)


_COPIES: dict = {}


def copy_of(name: str, side: str, maps=((), ())) -> Copy:
    if (name, side) not in _COPIES:
        _COPIES[name, side] = Copy(name, side, maps)
    return _COPIES[name, side]


# -- canonical values ----------------------------------------------------------

def _plain(x, depth=0):
    if depth > 12:
        return "<deep>"
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else repr(x)
    if isinstance(x, (bytes, bytearray, memoryview)):
        return {"bytes": bytes(x).hex()}
    if isinstance(x, enum.Enum):
        return _plain(x.value, depth + 1)
    if isinstance(x, dict):
        return {json.dumps(_plain(k, depth + 1), sort_keys=True):
                _plain(v, depth + 1) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return {"set": _sorted(_plain(v, depth + 1) for v in x)}
    if isinstance(x, (list, tuple, deque)):
        return [_plain(v, depth + 1) for v in x]
    if isinstance(x, BaseException):
        return {"exc": type(x).__name__, "msg": str(x)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__, **{
            f.name: _plain(getattr(x, f.name), depth + 1)
            for f in dataclasses.fields(x)}}
    if hasattr(x, "tolist"):
        return _plain(x.tolist(), depth + 1)
    if inspect.isclass(x) or callable(x):
        return {"callable": getattr(x, "__name__", type(x).__name__)}
    return {"type": type(x).__name__}


_ADDR = re.compile(r"0x[0-9a-f]{6,}")


def canon(x) -> str:
    return _ADDR.sub("0x?", json.dumps(_plain(x), sort_keys=True))


def _sorted(values) -> list:
    return sorted(values, key=lambda v: json.dumps(v, sort_keys=True))


def _resort(x):
    """A canonical value after a name map, whose renames can change the
    order of a set's members: each set sorted again."""
    if isinstance(x, dict):
        if list(x) == ["set"] and isinstance(x["set"], list):
            return {"set": _sorted(_resort(v) for v in x["set"])}
        return {k: _resort(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_resort(v) for v in x]
    return x


def ref_to_port(entry: str, maps=((), ())) -> str:
    """An entry of the reference's record in the port's names."""
    if not (_MAPPED.search(entry) or any(maps)):
        return entry
    mapped = port_string(entry, maps)
    if mapped == entry:
        return entry
    return json.dumps(_resort(json.loads(mapped)), sort_keys=True)


#: substrings one of which a string must hold for the name map to change it
_MAPPED = re.compile(r"tpu|runtime|multislice|per-chip|megascale|tfd_|"
                     r"accelerator|2x2x1|2x4|google", re.I)


def _short(entry: str) -> str:
    if len(entry) <= 4096:
        return entry
    return (f"{entry[:512]}… ({len(entry)} chars, sha256 "
            f"{hashlib.sha256(entry.encode()).hexdigest()})")


# -- one scenario on both sides ------------------------------------------------

def cases(name: str) -> list:
    """(file, test function, parameter set) of every test of a reference
    file, in file order; the id is pytest's."""
    tree = ast.parse(open(os.path.join(TESTS, f"{name}.py")).read())
    out = []
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_")):
            continue
        params = [{}]
        for d in node.decorator_list:
            if isinstance(d, ast.Call) and ast.unparse(d.func) == \
                    "pytest.mark.parametrize":
                argnames = ast.literal_eval(d.args[0])
                argnames = [a.strip() for a in argnames.split(",")] \
                    if isinstance(argnames, str) else list(argnames)
                values = ast.literal_eval(d.args[1])
                params = [{**p, **dict(zip(argnames, v if len(argnames) > 1
                                           else (v,)))}
                          for p in params for v in values]
        for p in params:
            pid = "-".join(str(v) for v in p.values())
            out.append(pytest.param(name, node.name, p,
                                    id=f"{node.name}[{pid}]" if p
                                    else node.name))
    return out


def ported_cases(name: str) -> list:
    """``cases`` without the scenarios that wait for a module still to be
    ported or that the port's own tests translate."""
    return [c for c in cases(name)
            if f"{c.values[0]}.py::{c.values[1]}" not in WAITING | TRANSLATED]


@contextlib.contextmanager
def same_kinds():
    """The reference's device-kind table and defaults, for the length of
    the block, the port's (see the module's docstring)."""
    from tpu_operator.relay import compile_cache as rc
    from tpu_operator.relay import router as rr
    from tpu_operator.relay import service as rs
    from tpu_operator.relay import utilization as ru
    from tpu_operator_torch.relay import utilization as pu
    saved = (dict(ru.DEVICE_KIND_MODELS), ru.DEFAULT_KIND,
             rs.RelayService.__init__.__kwdefaults__["device_kind"],
             rc.BucketedCompileCache.__init__.__kwdefaults__["device_kind"],
             rr.RelayRouter.__init__.__kwdefaults__["device_kind"])
    ru.DEVICE_KIND_MODELS.clear()
    ru.DEVICE_KIND_MODELS.update({
        k: ru.DeviceKindModel(*dataclasses.astuple(m))
        for k, m in pu.DEVICE_KIND_MODELS.items()})
    ru.DEFAULT_KIND = pu.DEFAULT_KIND
    rs.RelayService.__init__.__kwdefaults__["device_kind"] = pu.DEFAULT_KIND
    rc.BucketedCompileCache.__init__.__kwdefaults__["device_kind"] = \
        pu.DEFAULT_KIND
    rr.RelayRouter.__init__.__kwdefaults__["device_kind"] = pu.DEFAULT_KIND
    try:
        yield
    finally:
        ru.DEVICE_KIND_MODELS.clear()
        ru.DEVICE_KIND_MODELS.update(saved[0])
        ru.DEFAULT_KIND = saved[1]
        rs.RelayService.__init__.__kwdefaults__["device_kind"] = saved[2]
        rc.BucketedCompileCache.__init__.__kwdefaults__["device_kind"] = \
            saved[3]
        rr.RelayRouter.__init__.__kwdefaults__["device_kind"] = saved[4]


def _call(copy: Copy, fn_name: str, params: dict, tmp: str):
    """Run one test function of ``copy`` with its fixtures; the record,
    and the exception it raised (None when it passed)."""
    os.makedirs(tmp, exist_ok=True)
    mp = pytest.MonkeyPatch()
    finalizers = []

    def resolve(name):
        if name in params:
            return params[name]
        if name == "tmp_path":
            import pathlib
            return pathlib.Path(tmp)
        if name == "monkeypatch":
            return mp
        if name == "caplog":
            return _Caplog()
        if name in copy.fixtures:
            fn = copy.ns[name]
            value = fn(*[resolve(a) for a in
                         inspect.signature(fn).parameters])
            if inspect.isgenerator(value):
                gen, value = value, next(value)
                finalizers.append(gen)
            return value
        raise LookupError(f"no fixture {name}")

    copy.log = []
    error = None
    try:
        fn = copy.ns[fn_name]
        fn(*[resolve(a) for a in inspect.signature(fn).parameters])
    except BaseException as e:          # recorded and compared
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        error = e
    finally:
        for gen in reversed(finalizers):
            with contextlib.suppress(StopIteration):
                next(gen)
        mp.undo()
    return [e.replace(tmp, "<tmp>") for e in copy.log], error


def run_case(name: str, fn_name: str, params: dict, tmp_path,
             maps=((), ()), assertions_only: bool = False) -> int:
    """Run one reference scenario on both sides and hold them equal; the
    number of values compared. ``maps``: the file's own name pairs
    (before the name map, after it); ``assertions_only``: hold the
    assertions on the port, not the records."""
    with same_kinds():
        ref, ref_err = _call(copy_of(name, "r"), fn_name, params,
                             str(tmp_path / "r"))
    port, port_err = _call(copy_of(name, "p", maps), fn_name, params,
                           str(tmp_path / "p"))
    if ref_err is not None:
        raise AssertionError(f"the reference's side failed under the "
                             f"port's kind table: {ref_err!r}") from ref_err
    if isinstance(port_err, NotPorted):
        raise AssertionError(f"{fn_name} reaches {port_err}, which is not "
                             f"ported: list it in WAITING")
    if assertions_only or f"{name}.py::{fn_name}" in ASSERTIONS_ONLY:
        if port_err is not None:
            raise port_err
        return 0
    ref = [ref_to_port(e, maps) for e in ref]
    for i, (r, p) in enumerate(zip(ref, port)):
        assert r == p, (f"value {i} of {len(ref)} differs:\n  reference "
                        f"{_short(r)}\n  port      {_short(p)}")
    if port_err is not None:
        raise port_err
    assert len(ref) == len(port), (len(ref), len(port))
    assert ref, "the scenario compared nothing"
    return len(ref)


# -- the harnesses ----------------------------------------------------------

#: the relay harnesses of ``e2e/``, each run with ``--ci``
HARNESSES = ("relay_serving", "serving_slo", "request_trace", "relay_mem",
             "relay_qos", "pump_speed", "utilization", "relay_tier", "spmd",
             "sessions", "reshard", "federation")

#: the host-clock fields of a harness's report: compared on their
#: invariant (a positive finite number on each side), never by value
HOST_CLOCK = {
    "pump_speed": ("throughput.scalar_rps", "throughput.vector_rps",
                   "throughput.speedup"),
    "request_trace": ("overhead.traced.wall_s", "overhead.untraced.wall_s",
                      "overhead.wall_ratio"),
    "utilization": ("overhead.bare.wall_s", "overhead.ledger.wall_s",
                    "overhead.wall_ratio"),
}

#: a gate on a host-clock figure, by harness (the start of its problem
#: text): it is held on the port's own report (``ok``), not compared
HOST_CLOCK_GATES = {"pump_speed": "vectorized pump speedup"}

#: the reference's harnesses name its TPU kind where the port's run ``h100``
HARNESS_NAMES = ((r"\bv5-lite\b", "h100"),)


#: the harnesses that count the process's allocated blocks
#: (``sys.getallocatedblocks``), which another thread of the test process
#: (pytest-xdist's I/O thread) moves when it runs during the count
PROCESS_COUNTERS = ("pump_speed",)


@contextlib.contextmanager
def _alone(harness: str):
    """For a harness of ``PROCESS_COUNTERS``, no other Python thread runs
    while it measures unless it blocks: the interpreter's switch interval
    is raised for the length of the block (a Python allocation needs the
    interpreter lock, so only its own thread's allocations count)."""
    if harness not in PROCESS_COUNTERS:
        yield
        return
    interval = sys.getswitchinterval()
    sys.setswitchinterval(600.0)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)


def _report(package: str, harness: str) -> dict:
    mod = importlib.import_module(f"{package}.e2e.{harness}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), _alone(harness):
        rc = mod.main(["--ci"])
    report = json.loads(out.getvalue())
    assert rc == (0 if report["ok"] else 1), (rc, report["ok"])
    return report


def _host_clock(report: dict, harness: str) -> dict:
    """``report`` with its host-clock fields replaced by their invariant
    and its host-clock gates taken out."""
    report = json.loads(json.dumps(report))
    for path in HOST_CLOCK.get(harness, ()):
        *parents, leaf = path.split(".")
        node = report
        for p in parents:
            node = node[p]
        v = node[leaf]
        node[leaf] = isinstance(v, (int, float)) and 0 < v < float("inf")
    if harness in HOST_CLOCK_GATES:
        report["problems"] = without_host_clock_gates(report["problems"],
                                                      harness)
        report["ok"] = not report["problems"]
    return report


def without_host_clock_gates(problems: list, harness: str) -> list:
    """``problems`` without the harness's host-clock gates
    (``HOST_CLOCK_GATES``): those are held by a test of their own, which
    measures again when a loaded machine reads under the bar."""
    gate = HOST_CLOCK_GATES.get(harness)
    return [p for p in problems if not (gate and p.startswith(gate))]


def harness_reports(harness: str) -> tuple:
    """The ``--ci`` reports of a harness on both copies (the reference's
    under ``same_kinds`` and through the name map), each with its
    host-clock fields on their invariants; and the port's report as it
    came."""
    with same_kinds():
        ref = _report("tpu_operator", harness)
    port = _report("tpu_operator_torch", harness)
    ref = to_port(ref, HARNESS_NAMES)
    return _host_clock(ref, harness), _host_clock(port, harness), port


#: the problems a port harness reports that are an open fault of the
#: reference, which the reference's harness reports too under the port's
#: kinds (ROADMAP queue 3): F13, the tier's scaling gate holds for the
#: reference's placeholder kind ``"tpu"`` and not for ``h100``
OPEN_FAULTS = {"relay_tier": [
    "4-replica aggregate rps only 2.65x single-replica (< 3x)"]}


def _differences(ref, port, path: str = "") -> list:
    """The paths where two reports differ, each with both values."""
    if isinstance(ref, dict) and isinstance(port, dict):
        return [d for key in sorted(set(ref) | set(port), key=str)
                for d in _differences(ref.get(key), port.get(key),
                                      f"{path}.{key}")]
    return [] if ref == port else [(path, ref, port)]


def check_harness(harness: str):
    """A harness's ``--ci`` report on the port equals the reference's
    after the name map (virtual-clock figures exactly, host-clock figures
    on their invariant), and the port's report has no problem but an
    open fault's and its host-clock gates'."""
    ref, port, raw = harness_reports(harness)
    assert ref == port, _differences(ref, port)
    assert without_host_clock_gates(raw["problems"], harness) == \
        OPEN_FAULTS.get(harness, [])
