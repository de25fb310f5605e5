"""The operator's client stack — the read-through cache (``kube/cache.py``),
the retrying client (``kube/retry.py``) and the chaos wrapper
(``kube/chaos.py``) — against the reference's.

The cache scenarios of ``tests/test_dag_cache.py:262-376``, the retry,
breaker and fault-injector scenarios of ``tests/test_chaos.py:145-315``
and the cache's watch-disconnect fallback (``:444``) run on both copies
with the same calls; what each returns or raises, the reads and writes
that reach the fake cluster, the counters and the sleeps must be equal
after the name map (``torch_sides``). The reconciler's converged pass
served from the cache is in ``test_torch_controllers.py``.

Waiting for the wire apiserver (``kube/apiserver.py``, the next slice):
``test_chaos.py``'s wire cases (``:105-143``),
``test_chaos_convergence_at_seeded_30pct`` and the sweep (``:486-505``).
"""

import threading
import time
from random import Random

import pytest

from torch_sides import both


def cm(S, name, data=None):
    return S.obj({"apiVersion": "v1", "kind": "ConfigMap",
                  "metadata": {"name": name, "namespace": "tpu-operator"},
                  "data": data or {"k": "v"}})


def outcome(fn):
    """What a call returned (an object's name and data) or raised (the
    error's class name)."""
    try:
        r = fn()
    except Exception as e:
        return ["raised", type(e).__name__]
    if isinstance(r, list):
        return [[o.name, o.raw.get("data")] for o in r]
    return [r.name, r.raw.get("data")] if r is not None else None


def cached(S, fake, **kw):
    return S.mod("kube.cache").CachedKubeClient(fake, watch=False, **kw)


def counts(c, fake):
    return {"hits": c.hits, "misses": c.misses,
            "api": sorted([list(k), v] for k, v in c.api_requests.items()),
            "reads": len(fake.reads), "writes": len(fake.actions)}


# -- the read-through cache (tests/test_dag_cache.py:262-376) -----------------

def s_cache_get_read_through_and_hit(S):
    fake = S.kube.FakeClient()
    fake.create(cm(S, "a"))
    c = cached(S, fake)
    out = [outcome(lambda: c.get("ConfigMap", "a", S.ns)), counts(c, fake)]
    out += [outcome(lambda: c.get("ConfigMap", "a", S.ns)), counts(c, fake)]
    c.get("ConfigMap", "a", S.ns).raw["data"]["k"] = "tampered"
    out += [outcome(lambda: c.get("ConfigMap", "a", S.ns)), counts(c, fake)]
    return out


def s_cache_notfound_tombstone_and_create_clears_it(S):
    fake = S.kube.FakeClient()
    c = cached(S, fake)
    out = [outcome(lambda: c.get("ConfigMap", "ghost", S.ns)),
           outcome(lambda: c.get("ConfigMap", "ghost", S.ns)),
           counts(c, fake)]
    c.create(cm(S, "ghost"))
    return out + [outcome(lambda: c.get("ConfigMap", "ghost", S.ns)),
                  counts(c, fake)]


def s_cache_primed_list_is_authoritative(S):
    fake = S.kube.FakeClient()
    fake.create(cm(S, "a", {"x": "1"}))
    fake.create(cm(S, "b"))
    c = cached(S, fake)
    return [outcome(lambda: c.list("ConfigMap", S.ns)),
            outcome(lambda: c.list("ConfigMap", S.ns)),
            outcome(lambda: c.get("ConfigMap", "a", S.ns)),
            outcome(lambda: c.get("ConfigMap", "never-existed", S.ns)),
            counts(c, fake)]


def s_cache_write_through_and_conflict_invalidation(S):
    fake = S.kube.FakeClient()
    fake.create(cm(S, "a"))
    c = cached(S, fake)
    obj = c.get("ConfigMap", "a", S.ns)
    obj.raw["data"] = {"k": "v2"}
    c.update(obj)
    out = [outcome(lambda: c.get("ConfigMap", "a", S.ns)), counts(c, fake)]
    side = fake.get("ConfigMap", "a", S.ns)
    side.raw["data"] = {"k": "side"}
    fake.update(side)
    stale = c.get("ConfigMap", "a", S.ns)
    stale.raw["data"] = {"k": "v3"}
    out.append(outcome(lambda: c.update(stale)))
    return out + [outcome(lambda: c.get("ConfigMap", "a", S.ns)),
                  counts(c, fake)]


def s_cache_delete_known_absent_is_local_noop(S):
    fake = S.kube.FakeClient()
    c = cached(S, fake)
    c.list("ConfigMap", S.ns)
    c.delete("ConfigMap", "was-never-there", S.ns)
    return counts(c, fake)


def s_cache_ttl_expiry_falls_back_to_live_reads(S):
    fake = S.kube.FakeClient()
    fake.create(cm(S, "a"))
    c = cached(S, fake, ttl_s=0.05)
    c.list("ConfigMap", S.ns)
    c.get("ConfigMap", "a", S.ns)
    out = [counts(c, fake)]
    time.sleep(0.08)
    c.list("ConfigMap", S.ns)
    return out + [counts(c, fake)]


def s_cache_invalidate_forces_live_read(S):
    fake = S.kube.FakeClient()
    fake.create(cm(S, "a"))
    c = cached(S, fake)
    c.get("ConfigMap", "a", S.ns)
    c.invalidate("ConfigMap")
    c.get("ConfigMap", "a", S.ns)
    return counts(c, fake)


def s_cache_metrics_mirror(S):
    """The counters mirrored into ``OperatorMetrics``: requests by verb and
    kind, hits and misses, lookups by op."""
    fake = S.kube.FakeClient()
    fake.create(cm(S, "a"))
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    c = S.mod("kube.cache").CachedKubeClient(fake, watch=False,
                                             metrics=metrics)
    c.get("ConfigMap", "a", S.ns)
    c.get("ConfigMap", "a", S.ns)
    c.list("ConfigMap", S.ns)
    c.create(cm(S, "b"))
    from torch_sides import samples
    return samples(metrics.registry, keep="api_requests|cache_|lookup")


# -- retries, the breaker, the fault injector (tests/test_chaos.py) ----------

def s_full_jitter_envelope_and_retry_after_floor(S):
    pol = S.mod("kube.retry").RetryPolicy(base_s=0.1, cap_s=1.0)
    rng = Random(42)
    out = [[pol.backoff_s(a, rng) for _ in range(50)] for a in range(1, 8)]
    return out + [pol.backoff_s(1, Random(0), retry_after=0.7),
                  pol.backoff_s(1, Random(0), retry_after=60.0)]


def flaky(S, n_failures, exc=None):
    client = S.mod("kube.client")

    class Flaky(client.KubeClient):
        def __init__(self):
            self.n_failures = n_failures
            self.exc = exc or client.ThrottledError("429", retry_after=0.01)
            self.calls = 0

        def get(self, kind, name, namespace=None):
            self.calls += 1
            if self.calls <= self.n_failures:
                raise self.exc
            return S.kube.Obj({"kind": kind, "metadata": {"name": name}})
    return Flaky()


def retrying(S, inner, **pol):
    retry = S.mod("kube.retry")
    sleeps = []
    rc = retry.RetryingKubeClient(inner, retry.RetryPolicy(**pol),
                                  rng=Random(7), sleep=sleeps.append)
    return rc, sleeps


def retry_view(rc, sleeps):
    return {"calls": rc.inner.calls, "retries": rc.retries,
            "by": sorted([list(k), v] for k, v in rc.retries_by.items()),
            "sleeps": sleeps, "breaker": rc.breaker.state,
            "opened": rc.breaker.open_total}


@pytest.mark.parametrize("case", ["succeeds", "exhausts", "permanent",
                                  "deadline"])
def s_retrying_client(S, case):
    client = S.mod("kube.client")
    if case == "succeeds":
        rc, sleeps = retrying(S, flaky(S, 2), max_attempts=5, base_s=0.01,
                              cap_s=0.1)
    elif case == "exhausts":
        rc, sleeps = retrying(S, flaky(S, 99), max_attempts=3, base_s=0.001,
                              cap_s=0.01, breaker_threshold=50)
    elif case == "permanent":
        rc, sleeps = retrying(S, flaky(S, 99, client.NotFoundError("nope")),
                              max_attempts=5)
    else:
        rc, sleeps = retrying(
            S, flaky(S, 99, client.ServerUnavailableError(
                "503", retry_after=10.0)),
            max_attempts=10, base_s=5.0, cap_s=30.0,
            deadlines_s={"get": 0.05})
    return [outcome(lambda: rc.get("Node", "n1")), retry_view(rc, sleeps)]


def s_circuit_breaker_trips_fast_fails_and_half_open_recovers(S):
    retry = S.mod("kube.retry")
    inner = flaky(S, 99)
    sleeps = []
    rc = retry.RetryingKubeClient(
        inner, retry.RetryPolicy(max_attempts=10, base_s=0.001, cap_s=0.01,
                                 breaker_threshold=3,
                                 breaker_cooldown_s=0.05),
        rng=Random(7), sleep=sleeps.append)
    out = [outcome(lambda: rc.get("Node", "n1")), retry_view(rc, sleeps),
           outcome(lambda: rc.get("Node", "n1")), retry_view(rc, sleeps)]
    time.sleep(0.06)
    out += [outcome(lambda: rc.get("Node", "n1")), retry_view(rc, sleeps)]
    time.sleep(0.06)
    inner.n_failures = 0
    out += [outcome(lambda: rc.get("Node", "n1")),
            outcome(lambda: rc.get("Node", "n1")), retry_view(rc, sleeps)]
    return out


def s_half_open_admits_single_probe(S):
    retry = S.mod("kube.retry")
    rc = retry.RetryingKubeClient(
        flaky(S, 99), retry.RetryPolicy(breaker_threshold=1,
                                        breaker_cooldown_s=0.01),
        rng=Random(1), sleep=lambda s: None)
    out = [outcome(lambda: rc.get("Node", "n1"))]
    time.sleep(0.02)
    b = rc.breaker
    return out + [b.allow(), b.state, b.allow()]


def s_retry_metrics(S):
    retry = S.mod("kube.retry")
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    rc = retry.RetryingKubeClient(
        flaky(S, 4), retry.RetryPolicy(max_attempts=10, base_s=0.001,
                                       cap_s=0.01, breaker_threshold=3,
                                       breaker_cooldown_s=0.0),
        rng=Random(3), sleep=lambda s: None, metrics=metrics)
    out = [outcome(lambda: rc.get("Node", "n1")),
           outcome(lambda: rc.get("Node", "n1"))]
    from torch_sides import samples
    return out + [samples(metrics.registry, keep="retries|circuit")]


def s_fault_injector_seeded_determinism(S):
    chaos = S.mod("kube.chaos")
    seq = [(v, k) for v in ("get", "list", "create", "update")
           for k in ("Node", "DaemonSet", "ConfigMap")] * 20
    rules = chaos.ChaosRules(rate=0.4, latency_rate=0.1, latency_s=0.001)
    runs = []
    for _ in range(2):
        inj = chaos.FaultInjector(rules, seed=99)
        runs.append([(f.kind, f.code) if f else None
                     for f in (inj.decide(v, k) for v, k in seq)])
    assert runs[0] == runs[1] and any(runs[0])
    return runs[0]


def s_fault_injector_scoping_by_verb_and_kind(S):
    chaos = S.mod("kube.chaos")
    inj = chaos.FaultInjector(chaos.ChaosRules(
        rate=1.0, verbs=frozenset(["get"]), kinds=frozenset(["Node"])),
        seed=1)
    return [inj.decide(v, k) is not None for v, k in (
        ("get", "Node"), ("list", "Node"), ("get", "ConfigMap"))]


def s_chaos_client_injects_typed_faults_and_watch_faults(S):
    chaos = S.mod("kube.chaos")
    fake = S.kube.FakeClient()
    fake.add_node("n1", {})
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    gone = chaos.ChaosKubeClient(fake, chaos.FaultInjector(
        chaos.ChaosRules(gone_rate=1.0), seed=1), metrics=metrics)
    out = [outcome(lambda: list(gone.watch("Node")))]
    dropper = chaos.ChaosKubeClient(fake, chaos.FaultInjector(
        chaos.ChaosRules(watch_drop_rate=1.0), seed=1), metrics=metrics)
    out.append(outcome(lambda: list(dropper.watch("Node", timeout_s=0.2))))
    err = chaos.ChaosKubeClient(fake, chaos.FaultInjector(
        chaos.ChaosRules(rate=1.0), seed=5), metrics=metrics)
    out.append(outcome(lambda: err.list("Node")))
    flags = chaos.rules_from_flags(0.3, 7, latency_s=0.0, latency_rate=0.0,
                                   verbs="get,list", kinds="Node",
                                   watch_drop_rate=0.0, gone_rate=0.0)
    from torch_sides import samples
    return out + [samples(metrics.registry, keep="chaos"),
                  chaos.rules_from_flags(0.0, 0) is None,
                  sorted(flags.rules.verbs), sorted(flags.rules.kinds)]


def s_cache_falls_back_to_ttl_after_watch_disconnect(S):
    """``test_chaos.py:444``: injected watch drops demote the prime, and
    the next read goes live and sees an out-of-band write."""
    chaos = S.mod("kube.chaos")
    fake = S.kube.FakeClient()
    fake.add_node(S.tr("tpu-node-1"), {})
    c = S.mod("kube.cache").CachedKubeClient(
        chaos.ChaosKubeClient(fake, chaos.FaultInjector(
            chaos.ChaosRules(watch_drop_rate=1.0), seed=2)), ttl_s=0.15)
    out = [[n.name for n in c.list("Node")]]
    live_lists = c.api_reads("list", "Node")
    deadline = time.monotonic() + 5.0     # the cache's watch subscribes
    while not fake._watchers and time.monotonic() < deadline:
        time.sleep(0.01)
    for i in range(4):
        n = fake.get("Node", S.tr("tpu-node-1"))
        n.metadata.setdefault("labels", {})["churn"] = str(i)
        fake.update(n)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if c._watch_state.get(("Node", None)) == "retry" and \
                ("Node", None) not in c._primed:
            break
        time.sleep(0.02)
    else:
        pytest.fail("watch drop never demoted the prime")
    n = fake.get("Node", S.tr("tpu-node-1"))
    n.metadata["labels"]["out-of-band"] = "yes"
    fake.update(n)
    nodes = c.list("Node")
    assert c.api_reads("list", "Node") > live_lists
    return out + [dict(nodes[0].labels)]


def s_retry_after_header_parsing(S):
    parse = S.mod("kube.incluster")._retry_after
    return [parse(h) for h in ({"Retry-After": "2"}, {"Retry-After": "0.5"},
                               {"Retry-After": "nonsense"},
                               {"Retry-After": "-1"}, {}, None)]


SCENARIOS = sorted((k[2:], v) for k, v in globals().items()
                   if k.startswith("s_") and k != "s_retrying_client")


@pytest.mark.parametrize("scenario", [v for _, v in SCENARIOS],
                         ids=[k for k, _ in SCENARIOS])
def test_client_stack_matches_the_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


@pytest.mark.parametrize("case", ["succeeds", "exhausts", "permanent",
                                  "deadline"])
def test_retrying_client_matches_the_reference(case):
    ref, port = both(s_retrying_client, case=case)
    assert port == ref


def test_fake_client_concurrent_update_same_object_is_conflict_safe():
    """``test_dag_cache.py:229`` on the port: racing writers through the
    cache each win or raise ``ConflictError``, never a torn write."""
    from tpu_operator_torch.kube import CachedKubeClient, FakeClient, Obj
    from tpu_operator_torch.kube.client import ConflictError
    fake = FakeClient()
    fake.create(Obj({"apiVersion": "v1", "kind": "ConfigMap",
                     "metadata": {"name": "shared",
                                  "namespace": "gpu-operator"},
                     "data": {"seq": "0"}}))
    c = CachedKubeClient(fake, watch=False)
    wins, conflicts = [], []

    def writer(i):
        obj = c.get("ConfigMap", "shared", "gpu-operator")
        obj.raw["data"] = {"seq": str(i), "writer": str(i)}
        try:
            c.update(obj)
            wins.append(i)
        except ConflictError:
            conflicts.append(i)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) + len(conflicts) == 16 and wins
    final = fake.get("ConfigMap", "shared", "gpu-operator")
    assert final.raw["data"]["writer"] == final.raw["data"]["seq"]
