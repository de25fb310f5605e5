"""The cluster-policy API (``api/v1alpha1.py``, ``crdgen.py``, ``schema.py``)
against the reference: ``tests/test_api.py``'s 14 scenarios run on both
copies, and each outcome of the port must equal the reference's after the
name map (``torch_names.to_port``: ``TPUClusterPolicy`` →
``GPUClusterPolicy``, ``libtpu`` → ``driver``, ``runtimeHook`` →
``containerToolkit``, ``multislice`` → ``multinode``, ``tpu.dev/`` →
``nvidia.com/``, the image variables). The port's checked-in CRD must
equal its generator, and the generated CRD must equal the reference's
after the map.

``test_cfg_validate_crd_and_schema_gate`` drives the reference's
``cli/cfg.py``, which the port does not have yet (the next slice): its
port runs the same two gates — the checked-in CRD against the generator, a
schema violation through ``validate_policy_object`` — without the CLI.
"""

import dataclasses
import os

import pytest
import yaml

import tpu_operator.api.crdgen as ref_crdgen
import tpu_operator.api.schema as ref_schema
import tpu_operator.api.v1alpha1 as ref_api
import tpu_operator_torch.api.crdgen as port_crdgen
import tpu_operator_torch.api.schema as port_schema
import tpu_operator_torch.api.v1alpha1 as port_api
from torch_names import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRD = os.path.join(ROOT, "tpu_operator_torch", "config", "crd", "bases",
                   "nvidia.com_gpuclusterpolicies.yaml")
SAMPLE = os.path.join(ROOT, "tpu_operator_torch", "config", "samples",
                      "v1alpha1_gpuclusterpolicy.yaml")
SIDES = {"r": (ref_api, ref_api.TPUClusterPolicy, "TPUClusterPolicy"),
         "p": (port_api, port_api.GPUClusterPolicy, "GPUClusterPolicy")}


def mk_policy(side, spec=None):
    _, Policy, kind = SIDES[side]
    return Policy.from_obj({"apiVersion": "x/v1alpha1", "kind": kind,
                            "metadata": {"name": "p"},
                            "spec": spec or {}})


def both(scenario):
    """``scenario(side, spec_of)`` on each copy; ``spec_of`` turns a
    reference-named spec into that side's. Returns the port's outcome after
    asserting it equals the reference's through the map."""
    ref = scenario("r", lambda s: s)
    port = scenario("p", to_port)
    assert port == to_port(ref)
    return port


def test_empty_spec_defaults():
    def scenario(side, _):
        s = mk_policy(side).spec
        drv = s.libtpu if side == "r" else s.driver
        ms = s.multislice if side == "r" else s.multinode
        return [drv.is_enabled(), s.device_plugin.is_enabled(),
                s.validator.is_enabled(),
                s.node_status_exporter.is_enabled(), ms.is_enabled(),
                s.device_plugin.resource_name,
                {"runtimeClass": s.operator.runtime_class}, s.validate()]
    assert both(scenario) == [True, True, True, False, False,
                              "nvidia.com/gpu", {"runtimeClass": "nvidia"},
                              []]


def test_explicit_disable_wins_over_default():
    def scenario(side, spec_of):
        p = mk_policy(side, spec_of({"libtpu": {"enabled": False},
                                     "nodeStatusExporter": {
                                         "enabled": True}}))
        drv = p.spec.libtpu if side == "r" else p.spec.driver
        return [drv.is_enabled(), p.spec.node_status_exporter.is_enabled()]
    assert both(scenario) == [False, True]


def test_camel_case_round_trip_preserves_unknown_keys():
    def scenario(side, spec_of):
        p = mk_policy(side, spec_of({
            "devicePlugin": {"resourceName": "example.com/x",
                             "somethingNew": {"x": 1}},
            "futureBlock": {"a": "b"}}))
        return [p.spec.device_plugin.resource_name, p.to_obj()["spec"]]
    name, out = both(scenario)
    assert name == "example.com/x" and out["futureBlock"] == {"a": "b"}
    assert out["devicePlugin"]["somethingNew"] == {"x": 1}


def test_sandbox_workloads_rejected():
    errs = both(lambda side, spec_of: mk_policy(side, spec_of(
        {"sandboxWorkloads": {"enabled": True}})).spec.validate())
    assert len(errs) == 1 and "no counterpart in this operator" in errs[0]


def test_validate_catches_bad_fields():
    errs = both(lambda side, spec_of: mk_policy(side, spec_of({
        "operator": {"defaultRuntime": "rkt"},
        "devicePlugin": {"resourceName": "noslash"},
        "validator": {"minEfficiency": 2.0},
        "libtpu": {"imagePullPolicy": "Sometimes",
                   "versionMap": {"v5p": ""}}})).spec.validate())
    assert len(errs) == 5
    assert any("driver.versionMap" in e for e in errs)


def test_image_resolution_precedence(monkeypatch):
    from tpu_operator_torch.api.v1alpha1 import ValidationError
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "env-registry/plugin:v9")

    def scenario(side, spec_of):
        out = [mk_policy(side, spec_of({"devicePlugin": {
            "image": "reg/x/plugin:v1"}})).image_path("device_plugin")]
        out.append(mk_policy(side, spec_of({"devicePlugin": {
            "repository": "reg/y", "image": "plugin",
            "version": "v2"}})).image_path("device_plugin"))
        out.append(mk_policy(side).image_path("device_plugin"))
        return out
    assert both(scenario) == ["reg/x/plugin:v1", "reg/y/plugin:v2",
                              "env-registry/plugin:v9"]
    monkeypatch.delenv("DEVICE_PLUGIN_IMAGE")
    with pytest.raises(ValidationError, match="DEVICE_PLUGIN_IMAGE"):
        mk_policy("p").image_path("device_plugin")
    # every component's env fallback, through the names
    assert port_api._IMAGE_ENV == {
        to_port(k): to_port(v) for k, v in ref_api._IMAGE_ENV.items()}


def test_node_status_exporter_reuses_validator_image(monkeypatch):
    monkeypatch.setenv("VALIDATOR_IMAGE", "reg/validator:v1")
    assert both(lambda side, _: mk_policy(side).image_path(
        "node_status_exporter")) == "reg/validator:v1"


def test_to_obj_from_obj_stable():
    def scenario(side, spec_of):
        _, Policy, _ = SIDES[side]
        p = mk_policy(side, spec_of({
            "libtpu": {"installDir": "/opt/lib", "enabled": True},
            "metricsExporter": {"serviceMonitor": {"enabled": True}}}))
        p2 = Policy.from_obj(p.to_obj())
        drv = p2.spec.libtpu if side == "r" else p2.spec.driver
        assert p2.to_obj() == p.to_obj()
        return [drv.install_dir,
                p2.spec.metrics_exporter.service_monitor_enabled(),
                p.to_obj()]
    out = both(scenario)
    assert out[0] == "/opt/lib" and out[1] is True
    assert out[2]["kind"] == "GPUClusterPolicy"
    assert out[2]["apiVersion"] == "nvidia.com/v1alpha1"


def test_validator_peak_overrides():
    def scenario(side, _):
        p = mk_policy(side, {"validator": {"peakTflops": 459.0,
                                           "peakHbmGbps": 2765.0}})
        out = [p.spec.validator.peak_tflops, p.spec.validate(),
               mk_policy(side).spec.validator.peak_tflops]
        for bad in (0, -5, "fast", True):
            out.append(mk_policy(side, {"validator": {
                "peakTflops": bad}}).spec.validate())
        return out
    out = both(scenario)
    assert out[:3] == [459.0, [], None]
    assert all(any("peakTflops" in e for e in errs) for errs in out[3:])


def test_every_spec_default_is_the_references():
    """Field for field, each sub-spec's defaults equal the reference's
    through the names (a GPU default differs only where the map says)."""
    ref = ref_api.TPUClusterPolicySpec().to_dict()
    port = port_api.GPUClusterPolicySpec().to_dict()
    assert port == to_port(ref)
    assert list(port_api._SPEC_TYPES) == [to_port(k) for k in
                                         ref_api._SPEC_TYPES]


# -- CRD schema ------------------------------------------------------------

def test_crd_matches_generator():
    assert open(CRD).read() == port_crdgen.render(), \
        f"regenerate: python -m tpu_operator_torch.api.crdgen > {CRD}"


def test_crd_is_the_references_through_the_names():
    assert port_crdgen.crd() == to_port(ref_crdgen.crd())


def test_crd_schema_covers_every_spec_field():
    top = port_crdgen.top_level_schema()["properties"]
    for key, cls in port_api._SPEC_TYPES.items():
        sub = top[port_api._camel(key)]
        assert "x-kubernetes-preserve-unknown-fields" not in sub, key
        for f in dataclasses.fields(cls):
            assert port_api._camel(f.name) in sub["properties"], (key, f.name)
        assert sub == port_crdgen.spec_schema(key, cls)


BAD = {"spec": {
    "operator": {"defaultRuntime": "rkt"},
    "validator": {"minEfficiency": 2.0, "peakTflops": -1},
    "metricsAgent": {"port": 70000},
    "devicePlugin": {"resourceName": "noslash"},
    "libtpu": {"versionMap": {"v5e": 123}},
    "upgradePolicy": {"drain": {"enable": "yes"}, "maxUnavailable": "25%"},
    "multislice": {"coordinatorPort": 0},
    "psa": {"enforce": "open"},
}}


def test_crd_schema_admission():
    sample = yaml.safe_load(open(SAMPLE))
    assert port_schema.validate_policy_object(sample) == []
    # the reference's sample, through the names, admits too
    ref_sample = yaml.safe_load(open(os.path.join(
        ROOT, "config", "samples", "v1alpha1_tpuclusterpolicy.yaml")))
    assert port_schema.validate_policy_object(to_port(ref_sample)) == []
    errs = port_schema.validate_policy_object(to_port(BAD))
    assert sorted(errs) == sorted(to_port(
        ref_schema.validate_policy_object(BAD)))
    for needle in ("defaultRuntime", "minEfficiency", "peakTflops", "port",
                   "resourceName", "versionMap", "drain.enable",
                   "coordinatorPort", "enforce"):
        assert any(needle in e for e in errs), (needle, errs)
    assert not any("maxUnavailable" in e for e in errs)
    spec_schema = port_schema.crd_spec_schema()["properties"]["spec"]
    pruned = port_schema.prune(
        {"driver": {"installDir": "/x", "typoField": 1},
         "validator": {"resources": {"limits": {"cpu": "1"}}}}, spec_schema)
    assert pruned["driver"] == {"installDir": "/x"}
    assert pruned["validator"]["resources"] == {"limits": {"cpu": "1"}}


def test_crd_and_schema_gates_without_the_cli(tmp_path):
    """test_api.py:163-180's two gates: a stale CRD differs from the
    generator; a policy file with an out-of-range port fails admission and
    the error names the value."""
    stale = tmp_path / "crd.yaml"
    stale.write_text("apiVersion: apiextensions.k8s.io/v1\n")
    assert stale.read_text() != port_crdgen.render()
    policy = yaml.safe_load("""
apiVersion: nvidia.com/v1alpha1
kind: GPUClusterPolicy
metadata: {name: t}
spec:
  metricsAgent: {port: 99999}
""")
    errs = port_schema.validate_policy_object(policy)
    assert errs and any("99999" in e for e in errs)


def test_schema_validate_fuzz_never_crashes():
    """Admission rejects or prunes arbitrary JSON-ish input and never
    raises; on every input the port's verdict is the reference's through
    the names."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    json_vals = st.recursive(
        st.none() | st.booleans() | st.integers(-10**6, 10**6)
        | st.floats(allow_nan=False, allow_infinity=False)
        | st.text(alphabet="abcxyz", max_size=20),
        lambda children: st.lists(children, max_size=4)
        | st.dictionaries(st.sampled_from(
            ["libtpu", "multislice", "devicePlugin", "validator", "port",
             "enabled", "versionMap", "coordinatorPort", "psa", "enforce",
             "x"]), children, max_size=4),
        max_leaves=20)
    spec_schema = port_schema.crd_spec_schema()["properties"]["spec"]

    @settings(max_examples=200, deadline=None)
    @given(json_vals)
    def check(v):
        errs = port_schema.validate_policy_object(
            {"spec": to_port(v), "status": to_port(v)})
        assert isinstance(errs, list)
        assert sorted(errs) == sorted(to_port(ref_schema.validate_policy_object(
            {"spec": v, "status": v})))
        port_schema.prune(to_port(v), spec_schema)

    check()
