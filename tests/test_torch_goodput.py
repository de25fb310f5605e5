"""The goodput engine (``observability/goodput.py``) against the
reference's.

The scenarios of ``tests/test_goodput.py`` run on both copies with the
same fleets, written in the reference's names and mapped onto the port's
(``torch_sides``): every report (fleet and per-slice scores, terms and
counts), the pacing verdicts, the status block, ``/debug/goodput``'s
payload and the goodput families must be equal after the name map. A
slice is ``nvidia.com/gpu.slice``, a chip a card (the ``nvidia.com/gpu``
capacity), an unhealthy one the health monitor's
``nvidia.com/gpu.<N>.health`` annotation.

One translation decision is not a name: a node that publishes no
capacity counts as one card in the port, four chips (a v5p host) in the
reference. The seeded fleets therefore give every node a capacity, drawn
as the reference draws its explicit ones, and
``test_a_node_without_capacity_is_one_card`` holds the port's default.
"""

import dataclasses
import random

import pytest

from torch_sides import Side, both, samples


def gp(S):
    return S.mod("observability.goodput")


def api(S):
    return S.mod("api.v1alpha1")


def node(S, name, sl, healthy=True, bad_chips=0, chips=4, eff=None,
         unsched=False, quarantined=False, permanent=False):
    labels = {"tpu.dev/chip.present": "true", "tpu.dev/slice": sl}
    if permanent:
        labels["tpu.dev/remediation.permanent-failure"] = "true"
    anns = {f"tpu.dev/chip.{i}.health": "injected" for i in range(bad_chips)}
    if eff is not None:
        anns["tpu.dev/validator.efficiency"] = str(eff)
    if quarantined:
        anns["tpu.dev/remediation-cordoned"] = "true"
    return S.obj({
        "apiVersion": "v1", "kind": "Node",
        "metadata": {"name": name, "labels": labels, "annotations": anns},
        "spec": {"unschedulable": unsched},
        "status": {"capacity": {"tpu.dev/chip": chips} if chips else {},
                   "conditions": [{"type": "tpu.dev/TPUHealthy",
                                   "status": "True" if healthy
                                   else "False"}]}})


def random_fleet(S, rng):
    nodes = []
    for s in range(rng.randint(1, 5)):
        for i in range(rng.randint(1, 8)):
            chips = rng.choice([2, 4, 8])
            nodes.append(node(
                S, f"s{s}-n{i}", f"slice-{s}", healthy=rng.random() > 0.3,
                bad_chips=rng.randint(0, chips), chips=chips,
                eff=rng.choice([None, round(rng.random(), 2)]),
                unsched=rng.random() > 0.85,
                quarantined=rng.random() > 0.85,
                permanent=rng.random() > 0.95))
    return nodes


def engine(S, metrics=None, clock=None, client=None):
    kw = {"metrics": metrics}
    if clock is not None:
        kw["clock"] = clock
    return gp(S).GoodputEngine(client or S.kube.FakeClient(), S.ns, **kw)


def report(r):
    return None if r is None else dataclasses.asdict(r)


def cluster(S, nodes):
    """A fake cluster of ``(name, slice)`` GPU nodes, four chips each."""
    c = S.kube.FakeClient(auto_ready=True)
    for name, sl in nodes:
        c.add_node(name, S.tr({"tpu.dev/chip.present": "true",
                               "tpu.dev/slice": sl}))
        c.patch("Node", name, patch={"status": {"capacity": S.tr(
            {"tpu.dev/chip": "4"})}}, subresource="status")
    return c


def set_health(S, c, name, ok):
    c.patch("Node", name, patch={"status": {"conditions": [
        {"type": S.mod("health.monitor").NODE_CONDITION_TYPE,
         "status": "True" if ok else "False"}]}}, subresource="status")


# -- scenarios (tests/test_goodput.py) ----------------------------------------

def s_scores_on_seeded_fleets(S, seeds):
    """``test_score_bounded_on_arbitrary_fleets``: bounded in [0, 1]."""
    eng, out = engine(S), []
    for seed in seeds:
        r = eng._score(random_fleet(S, random.Random(seed)),
                       api(S).GoodputSpec())
        assert 0.0 <= r.score <= 1.0
        out.append(report(r))
    return out


def s_score_monotone_in_unhealthy_chips(S, seeds):
    eng, spec, out = engine(S), api(S).GoodputSpec(), []
    prefix = S.tr("tpu.dev/chip.")
    for seed in seeds:
        rng = random.Random(1000 + seed)
        nodes = random_fleet(S, rng)
        before = eng._score(nodes, spec).score
        healthy = [n for n in nodes
                   if n.get("status", "conditions")[0]["status"] == "True"]
        if not healthy:
            continue
        victim = rng.choice(healthy)
        bad = sum(1 for k in victim.annotations if k.startswith(prefix))
        victim.annotations[f"{prefix}{bad}.health"] = "one more"
        after = eng._score(nodes, spec).score
        assert after <= before
        out.append([before, after])
    return out


def s_pacing_budget_at_or_below_floor(S, seeds):
    out = []
    for seed in seeds:
        rng = random.Random(2000 + seed)
        spec = api(S).GoodputSpec(pacing=True,
                                  floor=round(rng.uniform(0.5, 0.99), 2))
        eng = engine(S)
        nodes = random_fleet(S, rng)
        eng._spec = spec
        eng._report = eng._score(nodes, spec)
        budget = eng.remediation_budget(len(nodes))
        if eng._report.score <= spec.floor:
            assert budget == 0
        else:
            assert 1 <= budget <= len(nodes)
        out.append([budget, eng.upgrade_budget(len(nodes)),
                    eng.backoff_scale()])
    return out


def s_budget_none_when_pacing_off_or_unscored(S):
    eng = engine(S)
    out = [eng.remediation_budget(10)]
    eng._spec = api(S).GoodputSpec(pacing=False)
    eng._report = eng._score([node(S, "a", "s0")], eng._spec)
    return out + [eng.remediation_budget(10), eng.backoff_scale()]


def s_backoff_scale_doubles_below_floor(S):
    eng = engine(S)
    eng._spec = api(S).GoodputSpec(pacing=True, floor=0.9)
    eng._report = eng._score([node(S, "a", "s0"),
                              node(S, "b", "s0", healthy=False)], eng._spec)
    out = [eng.backoff_scale()]
    eng._report = eng._score([node(S, "a", "s0")], eng._spec)
    assert out + [eng.backoff_scale()] == [2.0, 1.0]
    return out + [eng.backoff_scale()]


def s_quorum_cliff_zeroes_availability(S):
    eng, spec = engine(S), api(S).GoodputSpec(quorum=0.5)
    nodes = [node(S, f"n{i}", "s0", healthy=i >= 3) for i in range(5)]
    out = [report(eng._score(nodes, spec))]
    nodes[2] = node(S, "n2", "s0")
    out.append(report(eng._score(nodes, spec)))
    assert out[0]["slices"][0]["availability"] == 0.0
    assert out[1]["slices"][0]["availability"] == 0.6
    return out


def s_chip_capacity(S):
    eng, spec = engine(S), api(S).GoodputSpec()
    r = report(eng._score([node(S, "a", "s0", chips=8, bad_chips=2)], spec))
    assert r["slices"][0]["chips"] == 8
    assert r["slices"][0]["availability"] == 0.75
    return r


def s_permanent_nodes_are_availability_loss_not_overhead(S):
    r = engine(S)._score(
        [node(S, "a", "s0"), node(S, "b", "s0", healthy=False, unsched=True,
                                  quarantined=True, permanent=True)],
        api(S).GoodputSpec())
    assert (r.slices[0].availability, r.slices[0].overhead) == (0.5, 1.0)
    return report(r)


def s_observe_disabled_clears_state(S):
    c = cluster(S, [("n0", "s0")])
    eng = engine(S, client=c)
    out = [report(eng.observe(S.policy())), eng.status_block(eng._report),
           eng.debug_json()]
    off = S.policy({"goodput": {"enabled": False}})
    out += [eng.observe(off), eng.status_block(None), eng.debug_json()]
    return out


def s_status_block_stable_and_names_worst_slice(S):
    c = cluster(S, [(f"n{i}", f"s{i % 2}") for i in range(4)])
    eng = engine(S, client=c)
    pol = S.policy()
    b1 = eng.status_block(eng.observe(pol))
    b2 = eng.status_block(eng.observe(pol))
    assert b1 == b2 and "worstSlice" not in b1
    set_health(S, c, "n0", False)
    block = eng.status_block(eng.observe(pol))
    assert block["worstSlice"]["name"] == "s0"
    return [b1, block, eng.debug_json()]


def s_degradation_episode_lands_in_histogram(S):
    c = cluster(S, [("n0", "s0"), ("n1", "s0")])
    clk = [1000.0]
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    eng = engine(S, metrics=metrics, clock=lambda: clk[0], client=c)
    pol = S.policy()
    set_health(S, c, "n0", False)
    eng.observe(pol)
    clk[0] += 300
    eng.observe(pol)
    clk[0] += 300
    set_health(S, c, "n0", True)
    eng.observe(pol)
    h = metrics.goodput_time_degraded_seconds
    assert (h.get(), h.sum()) == (1, 600.0)
    return [h.get(), h.sum(), samples(metrics.registry, keep="goodput")]


def s_goodput_spec_defaults_and_validation(S):
    spec = api(S).GoodputSpec()
    bad = S.policy({"goodput": {"floor": 1.7}})
    ok = S.policy({"goodput": {"floor": 0.8, "quorum": 0.25}})
    return [dataclasses.asdict(spec), bad.spec.validate(),
            [e for e in ok.spec.validate() if "goodput" in e]]


@pytest.mark.parametrize("pacing", [True, False])
def s_remediation_honors_pacer(S, pacing):
    c = cluster(S, [(f"n{i}", "s0") for i in range(6)])
    set_health(S, c, "n0", False)
    pol = S.policy({"goodput": {"pacing": pacing, "floor": 0.9},
                    "remediation": {"enabled": True,
                                    "maxUnavailable": "100%"}})
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    eng = engine(S, metrics=metrics, client=c)
    ctl = S.mod("controllers.remediation_controller").RemediationController(
        c, S.ns, metrics=metrics)
    ctl.pacer = eng
    r = eng.observe(pol)
    st = ctl.reconcile(pol)
    assert (st.quarantined, st.waiting) == ((0, 1) if pacing else (1, 0))
    return [report(r), dict(st.stages), samples(
        metrics.registry, keep="goodput|remediation")]


def s_pacing_never_widens_static_budget(S):
    c = cluster(S, [(f"n{i}", "s0") for i in range(10)])
    for name in ("n0", "n1"):
        set_health(S, c, name, False)
    pol = S.policy({"goodput": {"pacing": True, "floor": 0.5},
                    "remediation": {"enabled": True, "maxUnavailable": "1"}})
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    eng = engine(S, metrics=metrics, client=c)
    ctl = S.mod("controllers.remediation_controller").RemediationController(
        c, S.ns, metrics=metrics)
    ctl.pacer = eng
    eng.observe(pol)
    budget = eng.remediation_budget(10)
    st = ctl.reconcile(pol)
    assert budget > 1 and (st.quarantined, st.waiting) == (1, 1)
    return [budget, dict(st.stages),
            samples(metrics.registry, keep="goodput_effective|throttled")]


def s_slice_gauge_removed_when_slice_leaves_fleet(S):
    c = cluster(S, [("a0", "s0"), ("b0", "s1")])
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    eng = engine(S, metrics=metrics, client=c)
    pol = S.policy()
    eng.observe(pol)
    out = [samples(metrics.registry, keep="slice_score")]
    c.delete("Node", "b0")
    eng.observe(pol)
    out.append(samples(metrics.registry, keep="slice_score"))
    eng.observe(S.policy({"goodput": {"enabled": False}}))
    out.append(samples(metrics.registry, keep="slice_score"))
    assert out[2] == {}
    return out


SEEDED = ("s_scores_on_seeded_fleets", "s_score_monotone_in_unhealthy_chips",
          "s_pacing_budget_at_or_below_floor")
SCENARIOS = sorted((k[2:], v) for k, v in globals().items()
                   if k.startswith("s_") and k not in SEEDED
                   and k != "s_remediation_honors_pacer")


@pytest.mark.parametrize("scenario", [v for _, v in SCENARIOS],
                         ids=[k for k, _ in SCENARIOS])
def test_goodput_matches_the_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


@pytest.mark.parametrize("pacing", [True, False])
def test_remediation_honors_the_pacer_as_the_reference(pacing):
    ref, port = both(s_remediation_honors_pacer, pacing=pacing)
    assert port == ref


@pytest.mark.parametrize("name", [n[2:] for n in SEEDED])
def test_seeded_fleets_match_the_reference(name):
    """The reference's three seeded properties, 100 fleets each."""
    ref, port = both(globals()[f"s_{name}"], range(100))
    assert port == ref and port


def test_a_node_without_capacity_is_one_card():
    """The port's default where the reference assumes a v5p host's four
    chips: one bad card of a node that publishes no capacity leaves no
    card available (the reference: 3 of 4)."""
    S = Side("p")
    r = engine(S)._score([node(S, "b", "s0", chips=None, bad_chips=1)],
                         api(S).GoodputSpec())
    assert gp(S).DEFAULT_CHIPS == 1
    assert (r.slices[0].chips, r.slices[0].availability) == (1, 0.0)
    ref = engine(Side("r"))._score(
        [node(Side("r"), "b", "s0", chips=None, bad_chips=1)],
        api(Side("r")).GoodputSpec())
    assert (ref.slices[0].chips, ref.slices[0].availability) == (4, 0.75)


def test_the_product_is_the_slice_without_a_slice_label():
    """Without ``nvidia.com/gpu.slice`` a node's slice is its product, the
    reference's accelerator-group fallback."""
    S = Side("p")
    nodes = [S.kube.Obj({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": f"n{i}", "labels": {"nvidia.com/gpu.present": "true",
                                    "nvidia.com/gpu.product": p}},
        "status": {"capacity": {"nvidia.com/gpu": "8"}}})
        for i, p in enumerate(("H100", "H100", "A100"))]
    r = engine(S)._score(nodes, api(S).GoodputSpec())
    assert [(s.name, s.nodes, s.chips) for s in r.slices] == [
        ("A100", 1, 8), ("H100", 2, 16)]


def test_build_info_gauge():
    from tpu_operator_torch import __version__
    from tpu_operator_torch.controllers.metrics import OperatorMetrics
    metrics = OperatorMetrics()
    metrics.set_build_info()
    rendered = metrics.build_info.render()
    assert "gpu_operator_build_info" in rendered
    assert f'version="{__version__}"' in rendered
