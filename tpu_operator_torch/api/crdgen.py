"""CRD schema generator — controller-gen analogue.

The port of ``tpu_operator/api/crdgen.py``. The upstream operator generates
its CRD from Go struct markers (make manifests → controller-gen). Here the
dataclasses in v1alpha1.py are authoritative, and this module derives the
full structural openAPI v3 schema from them: every field of every sub-spec
is enumerated with its type, plus hand-maintained value constraints (enums,
bounds, patterns) in CONSTRAINTS. Free-form fields (labels, resources, …)
are the only ones left open, each listed explicitly in FREEFORM.

`python -m tpu_operator_torch.api.crdgen` prints the CRD;
tests/test_torch_api.py asserts the checked-in copy
(``tpu_operator_torch/config/crd/bases/``) matches, so schema drift fails
the way a stale zz_generated file would upstream.
"""

from __future__ import annotations

import copy
import dataclasses
import typing

from tpu_operator_torch.api import v1alpha1
from tpu_operator_torch.api.v1alpha1 import _SPEC_TYPES, _camel

PORT = {"type": "integer", "minimum": 1, "maximum": 65535}

# value constraints beyond what types give us, keyed by (spec key, field)
CONSTRAINTS: dict = {
    ("operator", "default_runtime"): {
        "enum": ["containerd", "docker", "crio"]},
    ("daemonsets", "update_strategy"): {"enum": ["RollingUpdate", "OnDelete"]},
    ("device_plugin", "resource_name"): {
        "pattern": r"^[a-z0-9.\-]+/[a-z0-9.\-]+$"},
    ("feature_discovery", "interval_seconds"): {"minimum": 1},
    ("metrics_agent", "port"): PORT,
    ("metrics_exporter", "port"): PORT,
    ("validator", "workload_matmul_dim"): {"minimum": 1},
    ("validator", "workload_collective_mb"): {"minimum": 1},
    # NB: apiextensions/v1 JSONSchemaProps uses the draft-4 BOOLEAN
    # exclusiveMinimum (modifies `minimum`), not the draft-2020 numeric
    # form — the numeric form fails to decode at `kubectl apply`
    ("validator", "min_efficiency"): {"minimum": 0, "maximum": 1},
    ("validator", "peak_tflops"): {"minimum": 0, "exclusiveMinimum": True},
    ("validator", "peak_hbm_gbps"): {"minimum": 0,
                                     "exclusiveMinimum": True},
    ("validator", "fabric_mesh_port"): PORT,
    ("multinode", "coordinator_port"): PORT,
    ("upgrade_policy", "max_parallel_upgrades"): {"minimum": 0},
    ("upgrade_policy", "wait_for_completion_timeout_seconds"): {"minimum": 0},
    ("health_monitor", "interval_seconds"): {"minimum": 1},
    ("health_monitor", "unhealthy_after_seconds"): {"minimum": 1},
    ("health_monitor", "healthy_after_seconds"): {"minimum": 1},
    ("remediation", "remediation_window_seconds"): {"minimum": 1},
    ("remediation", "max_retries"): {"minimum": 0},
    ("resharding", "max_model"): {"minimum": 1},
    ("resharding", "chips_per_node"): {"minimum": 1},
    ("goodput", "floor"): {"minimum": 0, "maximum": 1},
    ("goodput", "quorum"): {"minimum": 0, "maximum": 1},
    ("psa", "enforce"): {"enum": ["privileged", "baseline", "restricted"]},
    ("relay", "port"): PORT,
    ("relay", "replicas"): {"minimum": 1},
    ("relay", "pool_max_channels"): {"minimum": 1},
    ("relay", "pool_max_streams"): {"minimum": 1},
    ("relay", "pool_idle_timeout_seconds"): {"minimum": 1},
    ("relay", "admission_rate"): {"minimum": 0, "exclusiveMinimum": True},
    ("relay", "admission_burst"): {"minimum": 0, "exclusiveMinimum": True},
    ("relay", "admission_queue_depth"): {"minimum": 1},
    ("relay", "batch_max_size"): {"minimum": 1},
    ("relay", "batch_window_ms"): {"minimum": 0, "exclusiveMinimum": True},
    ("relay", "bypass_bytes"): {"minimum": 1},
    ("relay", "tenant_idle_seconds"): {"minimum": 1},
    ("relay", "scheduler"): {"enum": ["continuous", "window"]},
    # 0 disables deadline scheduling/shedding, so the floor is inclusive
    ("relay", "slo_ms"): {"minimum": 0},
    ("relay", "compile_cache_entries"): {"minimum": 1},
}

_PULL_POLICY = {"type": "string",
                "enum": ["Always", "IfNotPresent", "Never"]}

# typed schemas for fields whose python type (list/dict) is too loose
STRUCTURED: dict = {
    ("*", "image_pull_policy"): _PULL_POLICY,
    ("*", "image_pull_secrets"): {
        "type": "array", "items": {"type": "string"}},
    ("*", "env"): {
        "type": "array",
        "items": {"type": "object",
                  "required": ["name", "value"],
                  "properties": {"name": {"type": "string"},
                                 "value": {"type": "string"}}}},
    ("*", "args"): {"type": "array", "items": {"type": "string"}},
    ("driver", "version_map"): {
        "type": "object", "additionalProperties": {"type": "string"}},
    ("daemonsets", "rolling_update"): {
        "type": "object",
        "properties": {
            "maxUnavailable": {"x-kubernetes-int-or-string": True}}},
    ("metrics_exporter", "service_monitor"): {
        "type": "object",
        "properties": {"enabled": {"type": "boolean"},
                       "interval": {"type": "string"}}},
    ("upgrade_policy", "max_unavailable"): {
        "x-kubernetes-int-or-string": True},
    ("upgrade_policy", "drain"): {
        "type": "object",
        "properties": {
            "enable": {"type": "boolean"},
            "timeoutSeconds": {"type": "integer", "minimum": 0},
            "deleteEmptyDir": {"type": "boolean"}}},
    ("upgrade_policy", "pod_deletion"): {
        "type": "object",
        "properties": {"force": {"type": "boolean"},
                       "timeoutSeconds": {"type": "integer", "minimum": 0},
                       "deleteEmptyDir": {"type": "boolean"}}},
    ("health_monitor", "counter_thresholds"): {
        "type": "object", "additionalProperties": {"type": "integer"}},
    ("health_monitor", "hbm_sweep"): {
        "type": "object",
        "properties": {
            "enable": {"type": "boolean"},
            "sizeMb": {"type": "integer", "minimum": 1},
            "minGbps": {"type": "number", "minimum": 0}}},
    ("remediation", "max_unavailable"): {
        "x-kubernetes-int-or-string": True},
    ("remediation", "drain"): {
        "type": "object",
        "properties": {
            "enable": {"type": "boolean"},
            "timeoutSeconds": {"type": "integer", "minimum": 0}}},
    ("relay", "warm_start"): {
        "type": "array",
        "items": {"type": "object",
                  "required": ["op", "shape"],
                  "properties": {
                      "op": {"type": "string"},
                      "shape": {"type": "array",
                                "items": {"type": "integer", "minimum": 1}},
                      "dtype": {"type": "string"}}}},
    ("relay", "arena"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "blockBytes": {"type": "integer", "minimum": 4096},
            "maxBlocks": {"type": "integer", "minimum": 1}}},
    ("relay", "tracing"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "sampleRate": {"type": "number",
                           "minimum": 0, "maximum": 1},
            # 0 selects the adaptive p99 slow bar, so the floor is
            # inclusive
            "slowThresholdMs": {"type": "number", "minimum": 0},
            "recorderEntries": {"type": "integer", "minimum": 1},
            "keepTraces": {"type": "integer", "minimum": 1}}},
    ("relay", "router"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "port": {"type": "integer", "minimum": 1, "maximum": 65535},
            "vnodes": {"type": "integer", "minimum": 1},
            "capacityPerReplica": {"type": "integer", "minimum": 1},
            "spillover": {"type": "boolean"},
            "spilloverDepth": {"type": "integer", "minimum": 1}}},
    ("relay", "federation"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "port": {"type": "integer", "minimum": 1, "maximum": 65535},
            "cells": {"type": "integer", "minimum": 1},
            "vnodes": {"type": "integer", "minimum": 1},
            "spillCells": {"type": "integer", "minimum": 0},
            "headroomFloor": {"type": "number",
                              "minimum": 0, "maximum": 1},
            "replicateCache": {"type": "boolean"},
            "cellClasses": {"type": "array",
                            "items": {"type": "string"}},
            "tenantClassMap": {"type": "object",
                               "additionalProperties": {"type": "string"}},
            "tenantHomes": {"type": "object",
                            "additionalProperties": {"type": "string"}}}},
    ("relay", "qos"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "classes": {
                "type": "array",
                "items": {"type": "object",
                          "required": ["name"],
                          "properties": {
                              "name": {"type": "string"},
                              "weight": {"type": "number", "minimum": 0,
                                         "exclusiveMinimum": True},
                              "rateMultiplier": {"type": "number",
                                                 "minimum": 0,
                                                 "exclusiveMinimum": True},
                              # lower = more important; negative allowed
                              "priority": {"type": "integer"}}}},
            "tenantClassMap": {"type": "object",
                               "additionalProperties": {"type": "string"}},
            "defaultClass": {"type": "string"}}},
    ("relay", "utilization"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            # JSON string (not a nested object) so per-kind roofline
            # overrides pass through the env projection verbatim
            "deviceKindModelsJson": {"type": "string"},
            "burnRateFloor": {"type": "number",
                              "minimum": 0, "maximum": 1},
            "windowSeconds": {"type": "number", "minimum": 0,
                              "exclusiveMinimum": True}}},
    ("relay", "spmd"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            # ordered rules: first re.search match of pattern against the
            # op name wins; axes name the mesh axes the op shards over
            "partitionRules": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "pattern": {"type": "string"},
                        "axes": {"type": "array",
                                 "items": {"type": "string",
                                           "enum": ["data", "model"]}}}}},
            "maxConcurrentShards": {"type": "integer", "minimum": 1}}},
    ("relay", "sessions"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "maxSessions": {"type": "integer", "minimum": 1},
            "pageBytes": {"type": "integer", "minimum": 64},
            "spillDir": {"type": "string"},
            # only the two built-in request classes are mappable; the
            # value is a QoS class name resolved at the replica
            "classMap": {"type": "object",
                         "additionalProperties": {"type": "string"}},
            "idleTimeoutSeconds": {"type": "number", "minimum": 0}}},
    ("relay", "autoscaler"): {
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "minReplicas": {"type": "integer", "minimum": 1},
            "maxReplicas": {"type": "integer", "minimum": 1},
            "lowMarginFrac": {"type": "number",
                              "minimum": 0, "maximum": 1},
            "highMarginFrac": {"type": "number",
                               "minimum": 0, "maximum": 1},
            "upAfter": {"type": "integer", "minimum": 1},
            "downAfter": {"type": "integer", "minimum": 1},
            "cooldown": {"type": "integer", "minimum": 0},
            "evalIntervalSeconds": {"type": "integer", "minimum": 1}}},
}

# genuinely free-form maps: stay open, but each is a deliberate entry here
FREEFORM: dict = {
    ("*", "resources"): {  # k8s ResourceRequirements passthrough
        "type": "object", "x-kubernetes-preserve-unknown-fields": True},
    ("daemonsets", "labels"): {
        "type": "object", "additionalProperties": {"type": "string"}},
    ("daemonsets", "annotations"): {
        "type": "object", "additionalProperties": {"type": "string"}},
    ("daemonsets", "tolerations"): {  # k8s Toleration passthrough
        "type": "array",
        "items": {"type": "object",
                  "x-kubernetes-preserve-unknown-fields": True}},
}


def _field_schema(spec_key: str, f: dataclasses.Field) -> dict:
    for table in (STRUCTURED, FREEFORM):
        for key in ((spec_key, f.name), ("*", f.name)):
            if key in table:
                # deep copy so the emitted YAML has no anchors/aliases
                return copy.deepcopy(table[key])
    tp = f.type
    origin = typing.get_origin(tp)
    if origin is typing.Union or str(tp) in ("bool | None", "str | None",
                                             "int | None", "float | None"):
        tp = str(tp).split(" | ")[0]
    base = {"bool": {"type": "boolean"}, "str": {"type": "string"},
            "int": {"type": "integer"}, "float": {"type": "number"},
            "list": {"type": "array",
                     "items": {"type": "string"}},
            "dict": {"type": "object",
                     "additionalProperties": {"type": "string"}}}
    schema = copy.deepcopy(base.get(str(tp), {"type": "string"}))
    schema.update(copy.deepcopy(CONSTRAINTS.get((spec_key, f.name), {})))
    # apiserver-side defaulting for scalar defaults (kubebuilder `+default`
    # analogue, e.g. clusterpolicy_types.go:112): non-operator consumers of
    # a stored CR see the same values the dataclasses would apply
    if (f.default is not dataclasses.MISSING and f.default is not None
            and isinstance(f.default, (bool, str, int, float))):
        schema["default"] = f.default
    return schema


def spec_schema(spec_key: str, cls) -> dict:
    props = {}
    for f in dataclasses.fields(cls):
        props[_camel(f.name)] = _field_schema(spec_key, f)
    return {"type": "object", "properties": props}


def top_level_schema() -> dict:
    props = {_camel(key): spec_schema(key, cls)
             for key, cls in _SPEC_TYPES.items()}
    # rejected-if-enabled block still needs a schema so the error comes
    # from the operator with its explanation, not a prune
    props["sandboxWorkloads"] = {
        "type": "object",
        "properties": {"enabled": {"type": "boolean"},
                       "defaultWorkload": {"type": "string"}}}
    return {"type": "object", "properties": props}


def status_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "state": {"type": "string",
                      "enum": [v1alpha1.State.IGNORED, v1alpha1.State.READY,
                               v1alpha1.State.NOT_READY,
                               v1alpha1.State.DISABLED]},
            "message": {"type": "string"},
            "lastTransitionTime": {"type": "string"},
            "namespace": {"type": "string"},
            "serverVersion": {"type": "string"},
            "clusterFlavor": {"type": "string"},
            "statesStatus": {"type": "object",
                             "additionalProperties": {"type": "string"}},
            # degraded-mode reconcile: per-state failure detail plus the
            # Degraded condition (the pass completed, some states failed)
            "stateErrors": {"type": "object",
                            "additionalProperties": {"type": "string"}},
            "conditions": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "type": {"type": "string"},
                        "status": {"type": "string"},
                        "reason": {"type": "string"},
                        "message": {"type": "string"},
                    }}},
            # rollout observability (reference: upgrade state metrics)
            "upgrades": {
                "type": "object",
                "additionalProperties": {"type": "integer"}},
            # health remediation FSM counts (observe/quarantine/drain/
            # remediate/verify/reintegrate), same shape as upgrades
            "remediation": {
                "type": "object",
                "additionalProperties": {"type": "integer"}},
            "slices": {
                "type": "object",
                "additionalProperties": {"type": "string"}},
            # elastic resharding snapshot: the live (data, model) plan,
            # its generation counter, and whether a transition is in
            # flight (observers poll inFlight to detect cutovers)
            "resharding": {
                "type": "object",
                "properties": {
                    "generation": {"type": "integer"},
                    "data": {"type": "integer"},
                    "model": {"type": "integer"},
                    "chips": {"type": "integer"},
                    "nodes": {"type": "integer"},
                    "inFlight": {"type": "boolean"},
                    "lastTransition": {"type": "string",
                                       "enum": ["shrink", "expand"]},
                }},
            # fleet ML Productivity Goodput snapshot (score = availability
            # × efficiency × overhead, card-weighted across slices)
            "goodput": {
                "type": "object",
                "properties": {
                    "score": {"type": "number"},
                    "availability": {"type": "number"},
                    "efficiency": {"type": "number"},
                    "overhead": {"type": "number"},
                    "floor": {"type": "number"},
                    "slices": {"type": "integer"},
                    "degradedSlices": {"type": "integer"},
                    "pacing": {"type": "string",
                               "enum": ["on", "off"]},
                    "worstSlice": {
                        "type": "object",
                        "properties": {
                            "name": {"type": "string"},
                            "score": {"type": "number"}}},
                }},
        },
    }


def crd() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "gpuclusterpolicies.nvidia.com"},
        "spec": {
            "group": "nvidia.com",
            "names": {"kind": "GPUClusterPolicy",
                      "listKind": "GPUClusterPolicyList",
                      "plural": "gpuclusterpolicies",
                      "singular": "gpuclusterpolicy",
                      "shortNames": ["gpucp", "gpupolicy"]},
            "scope": "Cluster",
            "versions": [{
                "name": "v1alpha1",
                "served": True,
                "storage": True,
                "additionalPrinterColumns": [
                    {"name": "Status", "type": "string",
                     "jsonPath": ".status.state"},
                    {"name": "Age", "type": "date",
                     "jsonPath": ".metadata.creationTimestamp"},
                ],
                "subresources": {"status": {}},
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {"spec": top_level_schema(),
                                   "status": status_schema()}}},
            }],
        },
    }


HEADER = (
    "# GPUClusterPolicy CRD — cluster-scoped singleton (reference analogue:\n"
    "# ClusterPolicy CRD, api/v1/clusterpolicy_types.go:1437-1443).\n"
    "# GENERATED by `python -m tpu_operator_torch.api.crdgen > "
    "tpu_operator_torch/config/crd/bases/nvidia.com_gpuclusterpolicies.yaml`"
    "\n# from tpu_operator_torch/api/v1alpha1.py (authoritative) — edit "
    "there.\n")


def render() -> str:
    import yaml
    return HEADER + yaml.safe_dump(crd(), sort_keys=False,
                                   default_flow_style=False)


if __name__ == "__main__":
    import sys
    sys.stdout.write(render())
