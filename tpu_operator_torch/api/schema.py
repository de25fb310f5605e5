"""Structural-schema validation — the admission half of the CRD contract.

The port of ``tpu_operator/api/schema.py``, on the port's generated CRD.

A real kube-apiserver validates CR writes against the CRD's structural
openAPI v3 schema. This module implements the subset our generated CRD
uses (type, properties, additionalProperties, items, enum, bounds,
pattern, required, int-or-string, preserve-unknown-fields) so the same
rejection a cluster would produce is testable offline: the cfg CLI runs
CR files through it, and the wire-protocol apiserver tier admits CR
writes with it.

Matching apiserver semantics for structural schemas: unknown fields are
PRUNED (removed, not rejected) unless the schema says
x-kubernetes-preserve-unknown-fields — the reference's generated CRD
behaves the same way; value violations on known fields are errors.
"""

from __future__ import annotations

import re


def validate(instance, schema: dict, path: str = "") -> list[str]:
    """Errors for ``instance`` against ``schema``; [] = admitted."""
    errs: list[str] = []
    _walk(instance, schema, path or "$", errs)
    return errs


def prune(instance, schema: dict):
    """Return a copy of ``instance`` with unknown object fields removed,
    as the apiserver does for structural schemas."""
    if not isinstance(instance, dict) or schema.get("type") != "object":
        return instance
    if schema.get("x-kubernetes-preserve-unknown-fields"):
        return instance
    props = schema.get("properties")
    addl = schema.get("additionalProperties")
    out = {}
    for k, v in instance.items():
        if props is not None and k in props:
            out[k] = prune(v, props[k])
        elif addl:
            out[k] = v if not isinstance(addl, dict) else prune(v, addl)
        elif props is None:
            out[k] = v
        # else: unknown field on a closed object — pruned
    return out


def _type_ok(v, t: str) -> bool:
    if t == "object":
        return isinstance(v, dict)
    if t == "array":
        return isinstance(v, list)
    if t == "string":
        return isinstance(v, str)
    if t == "boolean":
        return isinstance(v, bool)
    if t == "integer":
        return isinstance(v, int) and not isinstance(v, bool)
    if t == "number":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    return True


def _walk(v, schema: dict, path: str, errs: list[str]):
    if v is None:
        # k8s treats explicit nulls on optional fields as absent
        return
    if schema.get("x-kubernetes-int-or-string"):
        if not (isinstance(v, str)
                or (isinstance(v, int) and not isinstance(v, bool))):
            errs.append(f"{path}: expected integer or string, got "
                        f"{type(v).__name__}")
        return
    t = schema.get("type")
    if t and not _type_ok(v, t):
        errs.append(f"{path}: expected {t}, got {type(v).__name__}")
        return
    if "enum" in schema and v not in schema["enum"]:
        errs.append(f"{path}: {v!r} not one of "
                    f"{', '.join(map(str, schema['enum']))}")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        if "minimum" in schema:
            # draft-4 boolean exclusiveMinimum, the apiextensions/v1 form
            if schema.get("exclusiveMinimum") is True:
                if v <= schema["minimum"]:
                    errs.append(f"{path}: {v} must be > "
                                f"{schema['minimum']}")
            elif v < schema["minimum"]:
                errs.append(f"{path}: {v} below minimum "
                            f"{schema['minimum']}")
        if "maximum" in schema and v > schema["maximum"]:
            errs.append(f"{path}: {v} above maximum {schema['maximum']}")
    if isinstance(v, str) and "pattern" in schema:
        if not re.search(schema["pattern"], v):
            errs.append(f"{path}: {v!r} does not match "
                        f"{schema['pattern']!r}")
    if isinstance(v, dict):
        for req in schema.get("required", []):
            if req not in v:
                errs.append(f"{path}: missing required field {req!r}")
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        for k, sub in v.items():
            if k in props:
                _walk(sub, props[k], f"{path}.{k}", errs)
            elif isinstance(addl, dict):
                _walk(sub, addl, f"{path}.{k}", errs)
            # unknown keys: pruned by the server, not an error (see prune)
    if isinstance(v, list) and "items" in schema:
        for i, item in enumerate(v):
            _walk(item, schema["items"], f"{path}[{i}]", errs)


import functools


@functools.lru_cache(maxsize=1)
def crd_spec_schema() -> dict:
    """The generated GPUClusterPolicy openAPI schema (spec + status);
    immutable at runtime, so built once (validate/prune never mutate it)."""
    from tpu_operator_torch.api.crdgen import crd
    return crd()["spec"]["versions"][0]["schema"]["openAPIV3Schema"]


def validate_policy_object(obj: dict) -> list[str]:
    """Admission-equivalent check of a full GPUClusterPolicy object."""
    schema = crd_spec_schema()["properties"]
    return validate(obj.get("spec", {}), schema["spec"], "spec") + \
        validate(obj.get("status", {}), schema["status"], "status")
