"""Wiring-drift pass.

One sub-spec field travels through five representations: the
``api/v1alpha1.py`` dataclass, the ``api/crdgen.py``-generated openAPI
schema, TWO checked-in CRD YAML copies (``config/crd/bases/`` and
``deployments/gpu-operator/crds/``, both under ``tpu_operator_torch/``),
the chart's ``values.yaml``, and — for operand-consumed fields — a
``transform_*`` env projection matched by an env read in the operand
binary.  Until this pass, every PR regenerated
that chain by hand ("bump both CRD copies" was a recurring satellite
task); now drift is a machine check.

Rules:

- ``wiring-crd-copy``: each checked-in CRD YAML must deep-equal the
  output of ``crdgen.render()`` (comment headers ignored).
- ``wiring-schema-field``: every dataclass field of every registered
  sub-spec appears (camelCased) in the generated schema.
- ``wiring-values-key``: every sub-spec has a block in chart
  ``values.yaml``, every key in such a block exists in the sub-spec's
  schema (chart-only keys are allowlisted), and nested objects recurse.
- ``wiring-template-ref``: the chart's ``templates/clusterpolicy.yaml``
  projects every sub-spec block (``.Values.<key>``) into the CR.
- ``wiring-transform-attr``: every ``spec.<attr>`` read inside a
  ``transform_*`` function resolves to a real field/accessor of the
  aliased sub-spec class (catches renames that leave a transform behind).
- ``wiring-env-unread``: every env var a relay/health transform projects
  is read by the corresponding CLI binary (a projected-but-never-read
  variable is dead config — exactly the drift this pass exists to stop).

The Python side is imported live (``v1alpha1``/``crdgen`` are the source
of truth); YAML/template/transform sources are read from ``ctx.root`` so
fixtures can doctor them.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from ..core import Context, Finding, dotted_name, filter_findings

RULES = ("wiring-crd-copy", "wiring-schema-field", "wiring-values-key",
         "wiring-template-ref", "wiring-transform-attr",
         "wiring-env-unread")

CRD_COPIES = (
    "tpu_operator_torch/config/crd/bases/nvidia.com_gpuclusterpolicies.yaml",
    "tpu_operator_torch/deployments/gpu-operator/crds/gpuclusterpolicy.yaml")
VALUES_YAML = "tpu_operator_torch/deployments/gpu-operator/values.yaml"
TEMPLATE = ("tpu_operator_torch/deployments/gpu-operator/templates/"
            "clusterpolicy.yaml")
TRANSFORMS = "tpu_operator_torch/controllers/object_controls.py"

# chart-only keys: consumed by chart templates, never part of the CR spec
_CHART_TOP_LEVEL = {"clusterPolicy", "serviceAccount", "rbac", "nfd"}
_CHART_OPERATOR_KEYS = {"repository", "image", "version", "imagePullPolicy",
                        "logLevel", "leaderElect", "metricsPort",
                        "resources", "tolerations"}
# chart-only keys inside non-operator spec blocks (Deployment knobs the
# operator reads from the CR but the chart also surfaces)
_CHART_BLOCK_KEYS: dict[str, set] = {
    "metricsExporter": {"serviceMonitor"},
}

# env projections checked read-side: transform function -> CLI module(s)
_ENV_CONTRACTS = (
    (("transform_relay_deployment",),
     ("tpu_operator_torch/cli/relay_service.py",), "RELAY_"),
    # the router's default replica factory is relay_service.build_service,
    # which "inherit[s] the relay env contract" — so RELAY_* vars the
    # router transform projects may be consumed by either module
    (("transform_relay_router_deployment",),
     ("tpu_operator_torch/cli/relay_router.py",
      "tpu_operator_torch/cli/relay_service.py"), "RELAY_"),
    # the federation's default cell factory is relay_router.build_router
    # (each cell is a full router tier), whose replica factory is in turn
    # relay_service.build_service — so any of the three modules may
    # consume a variable the federation transform projects
    (("transform_relay_federation_deployment",),
     ("tpu_operator_torch/cli/relay_federation.py",
      "tpu_operator_torch/cli/relay_router.py",
      "tpu_operator_torch/cli/relay_service.py"), "RELAY_"),
    (("transform_health_monitor",),
     ("tpu_operator_torch/cli/health_monitor.py",), ""),
)


def _camel(s: str) -> str:
    head, *rest = s.split("_")
    return head + "".join(p.title() for p in rest)


def _diff_paths(a, b, prefix="", out=None, cap=8):
    """Dotted paths where two parsed YAML trees disagree (capped)."""
    if out is None:
        out = []
    if len(out) >= cap:
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a:
                out.append(f"{prefix}{k} (only in checked-in copy)")
            elif k not in b:
                out.append(f"{prefix}{k} (missing from checked-in copy)")
            else:
                _diff_paths(a[k], b[k], f"{prefix}{k}.", out, cap)
            if len(out) >= cap:
                return out
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            out.append(f"{prefix[:-1]} (length {len(a)} != {len(b)})")
        else:
            for i, (x, y) in enumerate(zip(a, b)):
                _diff_paths(x, y, f"{prefix}{i}.", out, cap)
    elif a != b:
        out.append(f"{prefix[:-1]} ({a!r} != {b!r})")
    return out


def _check_crd_copies(ctx: Context) -> list[Finding]:
    import yaml
    from tpu_operator_torch.api import crdgen
    generated = yaml.safe_load(crdgen.render())
    findings = []
    for rel in CRD_COPIES:
        if not ctx.exists(rel):
            findings.append(Finding("wiring-crd-copy", rel, 1,
                                    "CRD copy is missing"))
            continue
        checked_in = yaml.safe_load(ctx.read(rel))
        diffs = _diff_paths(generated, checked_in)
        for d in diffs:
            findings.append(Finding(
                "wiring-crd-copy", rel, 1,
                f"drifted from crdgen.render(): {d} — regenerate with "
                f"python -m tpu_operator_torch.api.crdgen"))
    return findings


def _check_schema_fields() -> list[Finding]:
    from tpu_operator_torch.api import crdgen, v1alpha1
    findings = []
    for key, cls in v1alpha1._SPEC_TYPES.items():
        schema = crdgen.spec_schema(key, cls)
        props = schema.get("properties", {})
        for f in dataclasses.fields(cls):
            if _camel(f.name) not in props:
                findings.append(Finding(
                    "wiring-schema-field", "tpu_operator_torch/api/crdgen.py", 1,
                    f"spec.{key}: dataclass field '{f.name}' has no "
                    f"'{_camel(f.name)}' property in the generated schema"))
    return findings


def _check_values_block(key: str, block, schema: dict, path: str,
                        allow_extra: set, findings: list):
    if not isinstance(block, dict):
        return
    props = schema.get("properties", {})
    for k, v in block.items():
        if k in allow_extra:
            continue
        if k not in props:
            findings.append(Finding(
                "wiring-values-key", VALUES_YAML, 1,
                f"{path}.{k} is not a field of spec.{key} — rename it or "
                f"add the field to v1alpha1/crdgen"))
            continue
        sub = props[k]
        if isinstance(v, dict) and isinstance(sub.get("properties"), dict):
            _check_values_block(key, v, sub, f"{path}.{k}", set(), findings)


def _check_values(ctx: Context) -> list[Finding]:
    import yaml
    from tpu_operator_torch.api import crdgen, v1alpha1
    findings = []
    if not ctx.exists(VALUES_YAML):
        return [Finding("wiring-values-key", VALUES_YAML, 1,
                        "chart values.yaml is missing")]
    values = yaml.safe_load(ctx.read(VALUES_YAML)) or {}
    camel_keys = {_camel(k): k for k in v1alpha1._SPEC_TYPES}
    for top in values:
        if top not in camel_keys and top not in _CHART_TOP_LEVEL:
            findings.append(Finding(
                "wiring-values-key", VALUES_YAML, 1,
                f"top-level key '{top}' is neither a sub-spec nor an "
                f"allowlisted chart block"))
    for camel, snake in camel_keys.items():
        if camel not in values:
            findings.append(Finding(
                "wiring-values-key", VALUES_YAML, 1,
                f"sub-spec '{camel}' has no default block in values.yaml"))
            continue
        schema = crdgen.spec_schema(snake, v1alpha1._SPEC_TYPES[snake])
        extra = set(_CHART_BLOCK_KEYS.get(camel, set()))
        if camel == "operator":
            extra |= _CHART_OPERATOR_KEYS
        _check_values_block(snake, values[camel], schema, camel, extra,
                            findings)
    return findings


def _check_template(ctx: Context) -> list[Finding]:
    from tpu_operator_torch.api import v1alpha1
    findings = []
    if not ctx.exists(TEMPLATE):
        return [Finding("wiring-template-ref", TEMPLATE, 1,
                        "chart clusterpolicy template is missing")]
    text = ctx.read(TEMPLATE)
    refs = set(re.findall(r"\.Values\.([A-Za-z0-9]+)", text))
    for key in v1alpha1._SPEC_TYPES:
        if _camel(key) not in refs:
            findings.append(Finding(
                "wiring-template-ref", TEMPLATE, 1,
                f"template never projects .Values.{_camel(key)} into the "
                f"rendered GPUClusterPolicy — the chart block is dead"))
    return findings


# -- transform side --------------------------------------------------------

def _spec_attr_ok(cls, attr: str) -> bool:
    if attr in {f.name for f in dataclasses.fields(cls)}:
        return True
    return hasattr(cls, attr)


def _check_transforms(ctx: Context) -> list[Finding]:
    from tpu_operator_torch.api import v1alpha1
    mod = ctx.module(TRANSFORMS)
    if mod is None:
        return [Finding("wiring-transform-attr", TRANSFORMS, 1,
                        "object_controls.py is missing/unparseable")]
    findings = []
    for fn in ast.walk(mod.tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("transform_")):
            continue
        aliases: dict[str, type] = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                d = dotted_name(node.value)
                if d and d.startswith("ctx.policy.spec."):
                    key = d.split(".", 3)[3].split(".")[0]
                    cls = v1alpha1._SPEC_TYPES.get(key)
                    if cls is not None:
                        aliases[node.targets[0].id] = cls
        for node in ast.walk(fn):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases):
                cls = aliases[node.value.id]
                if not _spec_attr_ok(cls, node.attr):
                    findings.append(Finding(
                        "wiring-transform-attr", TRANSFORMS, node.lineno,
                        f"{fn.name}: spec.{node.attr} is not a field or "
                        f"accessor of {cls.__name__}"))
    return findings


def _projected_env(mod, fn_names) -> dict[str, int]:
    out: dict[str, int] = {}
    for fn in ast.walk(mod.tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name in fn_names):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "set_env"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                out.setdefault(node.args[1].value, node.lineno)
    return out


def _read_env(mod) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            is_env_get = (d.endswith("environ.get") or d == "env.get"
                          or d.split(".")[-1].startswith("_env_")
                          or d.startswith("_env_"))
            if (is_env_get and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names.add(node.args[0].value)
        elif (isinstance(node, ast.Subscript)
              and (dotted_name(node.value) or "").endswith("environ")
              and isinstance(node.slice, ast.Constant)
              and isinstance(node.slice.value, str)):
            names.add(node.slice.value)
    return names


def _check_env(ctx: Context) -> list[Finding]:
    mod = ctx.module(TRANSFORMS)
    if mod is None:
        return []
    findings = []
    for fn_names, cli_paths, prefix in _ENV_CONTRACTS:
        projected = _projected_env(mod, fn_names)
        readers: set[str] = set()
        for rel in cli_paths:
            cli = ctx.module(rel)
            if cli is not None:
                readers |= _read_env(cli)
        for name, line in sorted(projected.items()):
            if prefix and not name.startswith(prefix):
                continue
            if name not in readers:
                findings.append(Finding(
                    "wiring-env-unread", TRANSFORMS, line,
                    f"{fn_names[0]} projects {name} but "
                    f"{', '.join(cli_paths)} never reads it — dead config "
                    f"(consume it or drop the projection)"))
    return findings


def run(ctx: Context) -> list[Finding]:
    findings = []
    findings += _check_crd_copies(ctx)
    findings += _check_schema_fields()
    findings += _check_values(ctx)
    findings += _check_template(ctx)
    findings += _check_transforms(ctx)
    findings += _check_env(ctx)
    mods = {p: m for p, m in ((TRANSFORMS, ctx.module(TRANSFORMS)),)
            if m is not None}
    return filter_findings(mods, findings)
