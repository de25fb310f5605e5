"""ML Productivity Goodput engine — the single "is the fleet productive"
signal (PAPERS.md: "Machine Learning Fleet Efficiency ... with ML
Productivity Goodput"; Tenplex motivates slices as the unit workloads
care about).

The port of ``tpu_operator/observability/goodput.py``. A chip is a card: a
node's chips are its ``nvidia.com/gpu`` capacity (1 when it publishes
none: a GPU node has at least one card, where the reference assumed a
four-chip v5p host), its unhealthy ones the health monitor's
``nvidia.com/gpu.<N>.health`` annotations; a slice is
``nvidia.com/gpu.slice``, else the node's ``nvidia.com/gpu.product``.

Per slice, goodput decomposes exactly the way the paper does:

  goodput = availability x efficiency x overhead

- **availability**: the chip-weighted fraction of the slice that is
  schedulable AND healthy (nvidia.com/GPUHealthy condition + per-card
  nvidia.com/gpu.N.health annotations from health/monitor.py) — with a
  *quorum cliff*: below ``goodput.quorum`` (default 0.5) the term is 0,
  because a collective cannot even form on a minority of its hosts. The
  cliff is what makes goodput CONVEX in concurrent disruptions, and
  therefore what goodput-aware pacing exploits: two half-disrupted
  slices score worse than one fully-drained one.
- **efficiency**: chip-weighted mean of the validator-published
  ``nvidia.com/validator.efficiency`` node annotation (fraction of spec
  bf16 peak, validator/components.py) over the available chips; nodes
  without the annotation count as 1.0 — absence of data is not badput.
- **overhead**: 1 minus the fraction of the slice's nodes currently held
  by a disruptive action (remediation quarantine or upgrade cordon) —
  the failure/maintenance recovery term. Permanent-failure nodes are an
  availability loss, not recovery overhead, and are excluded.

Every input is a level signal read off the watch-maintained cache
(``list_readonly``), so a converged healthy fleet is scored with ZERO
API reads, and the score itself is a pure function of cluster state —
no decaying averages, no wall-clock coupling — so the status block it
feeds is byte-stable and the converged reconcile loop stays write-free.

Closing the loop (ROADMAP "Goodput-aware remediation and upgrades"):
when ``goodput.pacing`` is on, the remediation and upgrade FSMs ask the
engine for a disruption-budget verdict and take the MINIMUM of it and
their static maxUnavailable/maxParallel thresholds — the static limits
remain the hard ceiling; pacing can only tighten them, down to 0 while
the fleet is at or below the configured floor. The remediation attempt
window also doubles while the fleet is below the floor (backoff
consumes goodput).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from tpu_operator_torch.controllers.remediation_controller import (
    PERMANENT_LABEL, QUARANTINED_BY_US, _ro_anns, _ro_labels, node_reported_healthy)
from tpu_operator_torch.controllers.state_manager import (GPU_PRESENT_LABEL,
                                                          PRODUCT_LABEL)
from tpu_operator_torch.controllers.upgrade_controller import \
    CORDONED_BY_US as UPGRADE_CORDONED_BY_US
from tpu_operator_torch.health.monitor import GPU_ANNOTATION_PREFIX

# explicit slice membership; falls back to the product group label
# (remediation's "one group ~= one slice's host pool" convention)
SLICE_LABEL = "nvidia.com/gpu.slice"
# validator-published fraction of spec peak (validator/components.py
# "efficiency"); absent on nodes the validator hasn't benchmarked
EFFICIENCY_ANN = "nvidia.com/validator.efficiency"
# the capacity resource that counts a node's cards
GPU_RESOURCE = "nvidia.com/gpu"
# cards per node when the node publishes no capacity: a GPU node has one
DEFAULT_CHIPS = 1


@dataclass
class SliceGoodput:
    name: str
    nodes: int = 0
    chips: int = 0
    availability: float = 1.0
    efficiency: float = 1.0
    overhead: float = 1.0
    score: float = 1.0
    degraded: bool = False


@dataclass
class GoodputReport:
    score: float = 1.0
    availability: float = 1.0
    efficiency: float = 1.0
    overhead: float = 1.0
    floor: float = 0.0
    total_nodes: int = 0
    available_nodes: int = 0     # schedulable + healthy (pacer headroom base)
    degraded_slices: int = 0
    slices: list = field(default_factory=list)  # [SliceGoodput], name-sorted


def _chip_counts(node) -> tuple[int, int]:
    """(total, unhealthy) chips for one node. The monitor annotates only
    UNHEALTHY chips; capacity gives the denominator when published."""
    unhealthy = 0
    for k in _ro_anns(node):
        # the health monitor's nvidia.com/gpu.<N>.health
        if k.startswith(GPU_ANNOTATION_PREFIX) and k.endswith(".health"):
            unhealthy += 1
    cap = ((node.raw.get("status") or {}).get("capacity") or {})
    total = 0
    if GPU_RESOURCE in cap:
        try:
            total = int(cap[GPU_RESOURCE])
        except (TypeError, ValueError):
            total = 0
    if total <= 0:
        total = DEFAULT_CHIPS
    return total, min(unhealthy, total)


def _node_efficiency(node) -> float:
    raw = _ro_anns(node).get(EFFICIENCY_ANN)
    if raw is None:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except (TypeError, ValueError):
        return 1.0


class GoodputEngine:
    """Scores the fleet each reconcile pass and (optionally) paces the
    disruptive controllers off the result. ``clock`` is injectable so the
    seeded e2e harness measures time-in-degraded in virtual time."""

    def __init__(self, client, namespace: str = "gpu-operator",
                 metrics=None, clock=time.time):
        self.client = client
        self.namespace = namespace
        self.metrics = metrics
        self.clock = clock
        self._spec = None
        self._report: GoodputReport | None = None
        # slice name -> virtual ts the degradation episode started; the
        # time-in-degraded histogram observes on episode END only, so a
        # converged pass never touches it
        self._degraded_since: dict[str, float] = {}
        # slice names whose per-slice gauge child was published last pass;
        # slices that leave the fleet get their gauge child removed so the
        # series doesn't export a stale score forever
        self._published_slices: set[str] = set()

    # -- scoring ----------------------------------------------------------
    def observe(self, policy) -> GoodputReport | None:
        """One evaluation pass. Returns None (and clears state) when
        goodput.enabled is off."""
        spec = policy.spec.goodput
        if not spec.enabled:
            self._spec = None
            self._report = None
            self._degraded_since.clear()
            if self.metrics is not None:
                for name in self._published_slices:
                    self.metrics.goodput_slice_score.remove(name)
            self._published_slices.clear()
            return None
        self._spec = spec
        selector = {GPU_PRESENT_LABEL: "true"}
        ro = getattr(self.client, "list_readonly", None)
        nodes = ro("Node", label_selector=selector) if ro else None
        if nodes is None:
            nodes = self.client.list("Node", label_selector=selector)
        report = self._score(nodes, spec)
        self._report = report
        self._publish(report)
        return report

    def _score(self, nodes, spec) -> GoodputReport:
        quorum = float(spec.quorum)
        floor = float(spec.floor)
        per: dict[str, dict] = {}
        available_nodes = 0
        for node in nodes:
            labels = _ro_labels(node)
            anns = _ro_anns(node)
            key = (labels.get(SLICE_LABEL)
                   or labels.get(PRODUCT_LABEL) or "default")
            s = per.setdefault(key, {
                "nodes": 0, "chips": 0, "healthy_chips": 0,
                "eff_weight": 0.0, "disrupted": 0})
            total, unhealthy = _chip_counts(node)
            s["nodes"] += 1
            s["chips"] += total
            permanent = labels.get(PERMANENT_LABEL) == "true"
            unsched = bool(node.get("spec", "unschedulable", default=False))
            healthy = (not unsched and not permanent
                       and node_reported_healthy(node))
            if healthy:
                good = total - unhealthy
                s["healthy_chips"] += good
                s["eff_weight"] += good * _node_efficiency(node)
                available_nodes += 1
            if not permanent and (
                    anns.get(QUARANTINED_BY_US) == "true"
                    or anns.get(UPGRADE_CORDONED_BY_US) == "true"):
                s["disrupted"] += 1

        slices: list[SliceGoodput] = []
        for name in sorted(per):
            s = per[name]
            chips = s["chips"]
            frac = s["healthy_chips"] / chips if chips else 0.0
            avail = frac if frac >= quorum else 0.0
            eff = (s["eff_weight"] / s["healthy_chips"]
                   if s["healthy_chips"] else 1.0)
            over = (1.0 - s["disrupted"] / s["nodes"]) if s["nodes"] else 1.0
            score = avail * eff * over
            slices.append(SliceGoodput(
                name=name, nodes=s["nodes"], chips=chips,
                availability=round(avail, 4), efficiency=round(eff, 4),
                overhead=round(over, 4), score=round(score, 4),
                degraded=score < floor))

        report = GoodputReport(floor=floor, slices=slices,
                               total_nodes=len(nodes),
                               available_nodes=available_nodes,
                               degraded_slices=sum(
                                   1 for s in slices if s.degraded))
        w = sum(s.chips for s in slices)
        if w:
            report.score = round(
                sum(s.score * s.chips for s in slices) / w, 4)
            report.availability = round(
                sum(s.availability * s.chips for s in slices) / w, 4)
            report.efficiency = round(
                sum(s.efficiency * s.chips for s in slices) / w, 4)
            report.overhead = round(
                sum(s.overhead * s.chips for s in slices) / w, 4)
        return report

    # -- publication ------------------------------------------------------
    def _publish(self, report: GoodputReport):
        now = self.clock()
        # episode tracking runs even without metrics so /debug/goodput and
        # the e2e harness see consistent state
        for s in report.slices:
            if s.degraded:
                self._degraded_since.setdefault(s.name, now)
            else:
                started = self._degraded_since.pop(s.name, None)
                if started is not None and self.metrics is not None:
                    self.metrics.goodput_time_degraded_seconds.observe(
                        max(0.0, now - started))
        # a slice that left the fleet mid-episode ends its episode too
        live = {s.name for s in report.slices}
        for name in [n for n in self._degraded_since if n not in live]:
            started = self._degraded_since.pop(name)
            if self.metrics is not None:
                self.metrics.goodput_time_degraded_seconds.observe(
                    max(0.0, now - started))
        if self.metrics is None:
            return
        m = self.metrics
        m.goodput_score.set(report.score)
        m.goodput_floor.set(report.floor)
        m.goodput_degraded_slices.set(report.degraded_slices)
        for comp in ("availability", "efficiency", "overhead"):
            m.goodput_component.labels(comp).set(getattr(report, comp))
        for s in report.slices:
            m.goodput_slice_score.labels(s.name).set(s.score)
        for name in self._published_slices - live:
            m.goodput_slice_score.remove(name)
        self._published_slices = live

    # -- pacing (consumed by the remediation/upgrade FSMs) -----------------
    def _budget(self, total: int) -> int | None:
        """Goodput-derived disruption budget, or None when the engine has
        no opinion (scoring off, pacing off, or nothing scored yet).
        Callers take min(static, this): the verdict can only tighten the
        static maxUnavailable/maxParallel thresholds, never widen them."""
        spec, report = self._spec, self._report
        if spec is None or report is None or not spec.pacing:
            return None
        if report.score <= report.floor:
            return 0          # below the floor: freeze new disruptions
        # headroom: the score can afford to lose up to this fraction of the
        # available pool before touching the floor (score scales ~linearly
        # with availability away from the quorum cliff)
        k = int(report.available_nodes * (1.0 - report.floor / report.score))
        return max(1, min(k, total)) if total else 0

    def remediation_budget(self, total: int) -> int | None:
        return self._budget(total)

    def upgrade_budget(self, total: int) -> int | None:
        return self._budget(total)

    def backoff_scale(self) -> float:
        """Remediation attempt-window multiplier: retry slower while the
        fleet is below the goodput floor."""
        spec, report = self._spec, self._report
        if spec is None or report is None or not spec.pacing:
            return 1.0
        return 2.0 if report.score <= report.floor else 1.0

    # -- status / debug ---------------------------------------------------
    def status_block(self, report: GoodputReport | None) -> dict:
        """The ``status.goodput`` block — stable across converged passes
        (every value 4-dp rounded, worstSlice only while degraded, ties
        broken by name)."""
        if report is None:
            return {}
        block = {
            "score": report.score,
            "availability": report.availability,
            "efficiency": report.efficiency,
            "overhead": report.overhead,
            "floor": report.floor,
            "slices": len(report.slices),
            "degradedSlices": report.degraded_slices,
            "pacing": "on" if (self._spec is not None
                               and self._spec.pacing) else "off",
        }
        if report.degraded_slices:
            worst = min(report.slices, key=lambda s: (s.score, s.name))
            block["worstSlice"] = {"name": worst.name, "score": worst.score}
        return block

    def debug_json(self) -> dict:
        """Payload for the /debug/goodput endpoint: the fleet summary plus
        the full per-slice breakdown."""
        report = self._report
        if report is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "fleet": self.status_block(report),
            "slices": [{
                "slice": s.name, "nodes": s.nodes, "chips": s.chips,
                "availability": s.availability, "efficiency": s.efficiency,
                "overhead": s.overhead, "score": s.score,
                "degraded": s.degraded,
            } for s in report.slices],
        }
