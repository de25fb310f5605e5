"""Epoch-fenced leader election — active/standby HA for the reconcile loop.

The port of ``tpu_operator/controllers/leader.py``: the Lease is
``gpu-operator-leader`` and its length ``GPU_OPERATOR_LEASE_SECONDS``.

The CLI has long had a plain Lease elector (cli/operator.py) gating the run
loop. That is enough to keep two replicas from BOTH reconciling in the
common case, but it cannot stop the classic failure: a leader that stalls
(GC pause, network partition) past its lease, keeps executing a pass it
started while it was still leader, and lands writes AFTER a standby took
over — duplicate or conflicting writes from a zombie.

This module closes that hole with two mechanisms:

- **Epoch fencing**: the Lease's ``leaseTransitions`` counter is bumped on
  every takeover and remembered by the acquirer as its *epoch* (the fencing
  token). A replica only trusts writes issued under its current epoch.
- **A local freshness window**: ``is_leader()`` refuses once
  ``RENEW_MARGIN`` (80%) of the lease has elapsed since the last successful
  renewal — strictly before a standby is ALLOWED to steal the lease (100%),
  so the zombie fences itself while the lease is still technically live.

``FencedClient`` puts the check on the write path itself: every mutating
verb calls ``check_fencing()`` first and raises ``FencingError`` when
leadership is stale, aborting the in-flight pass mid-stride instead of
letting it land one more write. Reads pass through unchecked — a stale
read is harmless and the converged-pass zero-read invariant is measured
below this wrapper.

Acquisition is read-modify-write with a read-back verification (the
in-repo fake/wire apiservers don't reject conflicting applies, so the
elector confirms it actually won before believing it). The injectable
``clock`` makes every failover scenario deterministic under test.
"""

from __future__ import annotations

import calendar
import os
import time
import uuid

from tpu_operator_torch.kube.client import KubeError
from tpu_operator_torch.kube.objects import Obj

LEASE_NAME = "gpu-operator-leader"
DEFAULT_LEASE_SECONDS = 30

# fraction of the lease a holder trusts itself without a successful renewal;
# MUST be < 1.0 (a standby can only acquire at 100%) or fencing has a hole
RENEW_MARGIN = 0.8

# a held lease is renewed at most this often (fraction of the lease) — the
# k8s renewDeadline idea; keeps a tight reconcile loop from writing the
# Lease every pass
RENEW_INTERVAL = 1 / 3


def lease_seconds_from_env() -> int:
    raw = os.environ.get("GPU_OPERATOR_LEASE_SECONDS", "")
    try:
        v = int(raw)
        if v >= 1:
            return v
    except (TypeError, ValueError):
        pass
    return DEFAULT_LEASE_SECONDS


def micro_time(t: float) -> str:
    """RFC3339 MicroTime as coordination.k8s.io/v1 requires."""
    frac = f"{t % 1:.6f}"[2:]
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + f".{frac}Z"


def parse_micro_time(s) -> float:
    if not s:
        return 0.0
    if isinstance(s, (int, float)):  # tolerate non-conformant writers
        return float(s)
    base, _, frac = str(s).rstrip("Z").partition(".")
    t = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
    return t + (float(f"0.{frac}") if frac else 0.0)


class FencingError(KubeError):
    """A write was attempted under stale leadership. The pass must abort;
    the standby (new epoch) owns the cluster now."""


class LeaderElector:
    """Lease-based election with epoch fencing and an injectable clock.

    ``try_acquire()`` is the only API-touching call; ``is_leader()`` and
    ``check_fencing()`` are pure local time math so they are safe on the
    per-write hot path.
    """

    def __init__(self, client, namespace: str, identity: str | None = None,
                 lease_seconds: int | None = None, clock=time.time,
                 metrics=None):
        self.client = client
        self.namespace = namespace
        self.identity = identity or \
            f"{os.uname().nodename}-{uuid.uuid4().hex[:6]}"
        self.lease_seconds = lease_seconds or lease_seconds_from_env()
        self.clock = clock
        self.metrics = metrics
        # fencing token: the Lease's leaseTransitions at our acquisition
        self.epoch = 0
        self._holding = False
        self._renewed_at = 0.0

    # -- local checks (no API traffic) ------------------------------------
    def is_leader(self) -> bool:
        """Leadership we may still act on: held AND renewed within the
        80% margin. Past the margin we self-fence even though the lease
        has not yet expired for standbys — that gap is the safety band."""
        return (self._holding
                and self.clock() - self._renewed_at
                < self.lease_seconds * RENEW_MARGIN)

    def check_fencing(self):
        if not self.is_leader():
            self._holding = False
            raise FencingError(
                f"fenced: {self.identity} (epoch {self.epoch}) is no "
                f"longer a trustworthy leader — aborting the write")

    # -- election ---------------------------------------------------------
    def try_acquire(self) -> bool:
        """Acquire or renew the lease. Renewals are throttled to a third
        of the lease; a takeover bumps the epoch (leaseTransitions) and
        ticks ``leader_transitions_total``."""
        now = self.clock()
        if self._holding and now - self._renewed_at \
                < self.lease_seconds * RENEW_INTERVAL:
            return True
        lease = self.client.get_or_none("Lease", LEASE_NAME, self.namespace)
        if lease is None:
            lease = Obj({"apiVersion": "coordination.k8s.io/v1",
                         "kind": "Lease",
                         "metadata": {"name": LEASE_NAME,
                                      "namespace": self.namespace},
                         "spec": {}})
        spec = lease.raw.setdefault("spec", {})
        holder = spec.get("holderIdentity")
        try:
            renew = parse_micro_time(spec.get("renewTime"))
        except ValueError:
            renew = 0.0
        # judge the HOLDER's expiry by the duration it published, not our
        # local setting (mixed configs must not split-brain)
        try:
            holder_duration = int(spec.get("leaseDurationSeconds")
                                  or self.lease_seconds)
        except (TypeError, ValueError):
            holder_duration = self.lease_seconds
        if holder not in (None, "", self.identity) and \
                now - renew < holder_duration:
            self._holding = False
            return False
        takeover = holder != self.identity
        try:
            transitions = int(spec.get("leaseTransitions") or 0)
        except (TypeError, ValueError):
            transitions = 0
        if takeover:
            transitions += 1
            spec["leaseTransitions"] = transitions
            spec["acquireTime"] = micro_time(now)
        spec["holderIdentity"] = self.identity
        spec["renewTime"] = micro_time(now)
        spec["leaseDurationSeconds"] = self.lease_seconds
        try:
            self.client.apply(lease)
            # read-back verification: the in-repo apiservers apply
            # last-writer-wins, so confirm we actually won the race before
            # trusting leadership
            check = self.client.get_or_none("Lease", LEASE_NAME,
                                            self.namespace)
        except KubeError:
            self._holding = False
            return False
        cspec = (check.raw.get("spec") or {}) if check is not None else {}
        if cspec.get("holderIdentity") != self.identity:
            self._holding = False
            return False
        try:
            self.epoch = int(cspec.get("leaseTransitions") or transitions)
        except (TypeError, ValueError):
            self.epoch = transitions
        self._holding = True
        self._renewed_at = now
        if takeover and self.metrics is not None:
            self.metrics.leader_transitions_total.inc()
        return True

    def resign(self):
        """Voluntary release (clean shutdown): zero the renewTime so a
        standby takes over immediately instead of waiting out the lease."""
        self._holding = False
        lease = self.client.get_or_none("Lease", LEASE_NAME, self.namespace)
        if lease is None:
            return
        spec = lease.raw.setdefault("spec", {})
        if spec.get("holderIdentity") != self.identity:
            return
        spec["holderIdentity"] = ""
        spec["renewTime"] = micro_time(0.0)
        try:
            self.client.apply(lease)
        except KubeError:
            pass


class FencedClient:
    """Write-barrier wrapper: every mutating verb re-validates leadership
    first (``FencingError`` on staleness), reads pass straight through.
    Sits innermost-but-one in the client stack — below the cache, so a
    fenced write never reaches the cache's write-through either."""

    _WRITE_VERBS = ("create", "update", "update_status", "patch", "delete",
                    "apply")

    def __init__(self, client, elector: LeaderElector):
        self._client = client
        self._elector = elector

    def __getattr__(self, name):
        attr = getattr(self._client, name)
        if name in self._WRITE_VERBS:
            elector = self._elector

            def fenced(*a, **kw):
                elector.check_fencing()
                return attr(*a, **kw)
            return fenced
        return attr
