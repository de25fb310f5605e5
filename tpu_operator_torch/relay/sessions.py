"""Stateful sessions: continuous-batched autoregressive decode with
KV-cache arena residency.

Every request the relay tier served before this module was one-shot; the
workload that serves real users is multi-step autoregressive decode with
per-session state. ``SessionManager`` adds that request lifecycle on top
of the existing fast path without forking it:

* **Two request classes, one fast path.** A session begins with a
  ``prefill`` request (large prompt-shaped dispatch, throughput-bound)
  and then issues ``decode_step`` requests (one token each,
  latency-bound). Both ride the ordinary ``submit()`` path; they differ
  only in shape, size, and QoS class — prefill maps to ``standard`` and
  decode to ``latency-critical`` by default, overridable via
  ``relay.sessions.classMap``, so the QoS classes' DWRR machinery prices
  prefill contention instead of letting it drown decode p99.
* **KV cache resident in the arena.** Each session leases ONE
  ``BufferLease`` from the pinned-buffer arena for its lifetime
  and grows it by page-sized ``LeaseView`` extents — one page appended
  per decode step, written through a refcounted extent window and
  released immediately. When the cache outgrows its block the manager
  re-leases the next power-of-two size class and copies the prefix —
  amortized-rare, and served from the warmed free lists at steady state,
  which is what keeps the "0 arena allocations per decode step"
  invariant (e2e/sessions.py pins it).
* **Eviction = preemption, never loss.** The ``maxSessions`` bound caps
  RESIDENT sessions; crossing it spills the least-recently-active
  session's KV bytes to ``sessionSpillDir`` — atomic ``tmp`` +
  ``os.replace``, the same discipline as the compile-cache spill — and
  the next decode step restores it (each spill file is consumed exactly
  once, so a double-restore is structurally impossible). The spill doc
  carries a sha256 of the KV prefix; restore verifies it, so a restored
  cache is byte-identical or loud.
* **Continuous batching across sessions.** Every decode step shares one
  (op, shape, dtype) identity, so the bucketed ``ExecutableKey`` —
  batch key and executable identity at once — coalesces steps from many
  live sessions into shared-shape batches through the existing
  vectorized scheduler; the SPMD path shards those batches over
  the live MeshPlan unchanged.
* **Router affinity's second key.** In tier mode the manager pins each
  session to the ring owner of ``session:<id>`` and decode steps route
  to exactly that replica (its arena holds the cache — spillover would
  break residency). Sessions migrate only on replica kill or
  scale-down, via spill+restore driven from the router's session hook,
  and the kill-resubmit ledger carries the session id so an orphaned
  decode step restores its session on a surviving replica BEFORE it is
  resubmitted — a replica kill loses zero sessions
  (tests/test_sessions.py proves it over 100 seeded schedules).

Clock-driven and hermetic like every relay component: the manager never
reads wall time directly, idle expiry runs from the owner's pump loop,
and the whole lifecycle is virtual-time testable.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import time
from dataclasses import dataclass, field

from tpu_operator_torch.kube.client import KubeError

# the built-in request-class → QoS-class mapping; relay.sessions.classMap
# overrides per entry (prefill is throughput work, decode is the
# latency-critical tail users actually feel)
DEFAULT_CLASS_MAP = {"prefill": "standard", "decode": "latency-critical"}

# the two session request classes share these wire identities fleet-wide:
# every decode step is a one-token dispatch over the model width, so ALL
# live sessions' steps bucket to one ExecutableKey and coalesce; prefill
# is prompt-shaped and buckets separately (different executable, different
# batch — exactly the two populations the QoS split prices)
PREFILL_OP = "session_prefill"
DECODE_OP = "session_decode"
MODEL_WIDTH = 512
DECODE_SHAPE = (1, MODEL_WIDTH)
PREFILL_SHAPE = (256, MODEL_WIDTH)
SESSION_DTYPE = "bf16"

_SPILL_VERSION = 1


class SessionError(KubeError):
    """A broken session-lifecycle contract — decode on an unknown or
    closed session, preemption with no ``sessionSpillDir`` to spill to,
    or a corrupt spill doc. Terminal (KubeError), not retryable: the
    caller holds a stale handle or a misconfiguration, and retrying
    cannot repair either."""


@dataclass
class SessionConfig:
    """Parsed ``relay.sessions`` sub-spec (the RELAY_SESSIONS_* env
    contract); ``from_spec`` accepts the wire shape with defaults."""

    enabled: bool = False
    max_sessions: int = 64
    page_bytes: int = 4096
    spill_dir: str = ""
    class_map: dict = field(default_factory=lambda: dict(DEFAULT_CLASS_MAP))
    idle_timeout_s: float = 300.0

    @classmethod
    def from_spec(cls, *, enabled: bool = False, max_sessions: int = 64,
                  page_bytes: int = 4096, spill_dir: str = "",
                  class_map: dict | None = None,
                  idle_timeout_seconds: float = 300.0) -> SessionConfig:
        cm = dict(DEFAULT_CLASS_MAP)
        if isinstance(class_map, dict):
            for k, v in class_map.items():
                if str(k) in cm and v:
                    cm[str(k)] = str(v)
        try:
            idle = max(0.0, float(idle_timeout_seconds))
        except (TypeError, ValueError):
            idle = 300.0
        return cls(enabled=bool(enabled),
                   max_sessions=max(1, int(max_sessions)),
                   page_bytes=max(64, int(page_bytes)),
                   spill_dir=str(spill_dir or ""),
                   class_map=cm, idle_timeout_s=idle)


def kv_page(session_id: str, step: int, page_bytes: int) -> bytes:
    """The KV bytes one step appends: a deterministic function of
    (session, step), so every harness and the 100-seed property test can
    recompute the exact expected cache contents after any sequence of
    spills, restores, migrations, and kills — byte-identity is checkable
    end to end, not just length."""
    seed = hashlib.sha256(f"{session_id}:{step}".encode()).digest()
    reps = -(-page_bytes // len(seed))
    return (seed * reps)[:page_bytes]


def expected_kv(session_id: str, steps: int, page_bytes: int) -> bytes:
    """The full expected KV prefix after ``steps`` appended pages (page 0
    is the prefill)."""
    return b"".join(kv_page(session_id, s, page_bytes)
                    for s in range(steps))


class Session:
    """One live session: its KV lease, its progress, and its placement."""

    __slots__ = ("session_id", "tenant", "state", "replica_id",
                 "lease", "kv_len", "steps_done", "next_step",
                 "pending_pages", "retry_steps", "inflight",
                 "last_active", "spills", "restores", "created_at")

    def __init__(self, session_id: str, tenant: str, now: float):
        self.session_id = session_id
        self.tenant = tenant
        self.state = "resident"        # resident | spilled | closed
        self.replica_id = ""           # tier mode: the pinned replica
        self.lease = None              # BufferLease while resident
        self.kv_len = 0                # contiguous KV bytes committed
        self.steps_done = 0            # contiguous pages appended
        self.next_step = 0             # next step ordinal to hand out
        self.pending_pages: set[int] = set()  # completed out of order
        self.retry_steps: set[int] = set()    # shed ordinals to re-issue
        self.inflight = 0              # submitted steps not yet terminal
        self.last_active = now
        self.spills = 0
        self.restores = 0
        self.created_at = now


class SessionManager:
    """The session front door over one ``RelayService`` or one
    ``RelayRouter`` tier.

    Exactly one of ``service``/``router`` is given. The manager chains
    itself onto the target's completion hook (the same chaining
    discipline the router uses on its replicas) so every decode step's
    terminal completion appends its KV page exactly once — including a
    step that died with its replica and completed later on the survivor
    it was resubmitted to. In tier mode it also registers as the
    router's session hook: ``kill()``/``remove()`` evacuate resident
    sessions through it before the replica's handle is discarded.
    """

    def __init__(self, config: SessionConfig, *, service=None, router=None,
                 clock=time.monotonic, metrics=None):
        if (service is None) == (router is None):
            raise ValueError("SessionManager fronts exactly one of "
                             "service= or router=")
        self.config = config
        self.metrics = metrics
        self._clock = clock
        self._service = service
        self._router = router
        self._sessions: dict[str, Session] = {}
        # rid -> (session_id, kind, step): the step ledger the completion
        # hook consumes; pop-once makes the page append exactly-once even
        # when a kill-resubmit completes the same rid on another replica
        self._pending: dict[int, tuple[str, str, int]] = {}
        # lifetime counters (stats(); metrics mirror them when wired)
        self.created = 0
        self.expired = 0
        self.preempted = 0
        self.spills = 0
        self.restores = 0
        self.migrations = 0
        self.decode_steps = 0
        self.kv_grows = 0
        self.shed_steps = 0
        if service is not None:
            prev = service._on_complete
            service._on_complete = self._service_hook(prev)
        else:
            router.attach_sessions(self)
            prev = router._on_complete
            router._on_complete = self._router_hook(prev)

    # -- completion hooks ---------------------------------------------------
    def _service_hook(self, prev):
        def hook(req, result):
            if prev is not None:
                prev(req, result)
            self._step_done(req.id, result)
        return hook

    def _router_hook(self, prev):
        def hook(rid, result):
            if prev is not None:
                prev(rid, result)
            self._step_done(rid, result)
        return hook

    # -- placement ----------------------------------------------------------
    def _pin(self, session_id: str) -> str:
        """Tier mode: the ring owner of the session key — router
        affinity's second key. Service mode: the one process."""
        if self._router is None:
            return ""
        return self._router.ring.owner(f"session:{session_id}")

    def _arena(self, replica_id: str, service=None):
        svc = service
        if svc is None:
            svc = self._service if self._router is None \
                else self._router.replica(replica_id)
        arena = getattr(svc, "arena", None)
        if arena is None:
            raise SessionError(
                "stateful sessions need the pinned-buffer arena "
                "(relay.arena.enabled=false leaves KV caches nowhere "
                "to live)")
        return arena

    def _allocate_rid(self) -> int:
        target = self._service if self._router is None else self._router
        return target.allocate_rid()

    def _submit(self, sess: Session, kind: str, op: str, shape: tuple,
                size_bytes: int, rid: int | None = None) -> int:
        qos_class = self.config.class_map.get(kind, "")
        if self._router is None:
            return self._service.submit(
                sess.tenant, op, shape, SESSION_DTYPE,
                size_bytes=size_bytes, rid=rid, qos_class=qos_class or None,
                session_id=sess.session_id)
        return self._router.submit(
            sess.tenant, op, shape, SESSION_DTYPE, size_bytes=size_bytes,
            qos_class=qos_class, rid=rid, session_id=sess.session_id)

    # -- lifecycle: create / decode / close ---------------------------------
    def create(self, session_id: str, tenant: str,
               prompt_bytes: int = 0) -> int:
        """Open a session: lease its KV block on the pinned replica,
        write the prefill page (step 0), and admit the prefill request.
        Returns the prefill's request id. Raises ``SessionError`` on a
        duplicate id and propagates admission/shed errors — an
        unadmitted session is rolled back, never half-created."""
        if session_id in self._sessions and \
                self._sessions[session_id].state != "closed":
            raise SessionError(f"session {session_id!r} already live")
        now = self._clock()
        sess = Session(session_id, tenant, now)
        sess.replica_id = self._pin(session_id)
        self._make_room(exclude=session_id)
        page = self.config.page_bytes
        sess.lease = self._arena(sess.replica_id).lease(page)
        self._sessions[session_id] = sess
        step = sess.next_step
        sess.next_step += 1
        sess.inflight += 1
        # ledger BEFORE submit (the router's own discipline): continuous
        # batching may dispatch — and complete — the prefill synchronously
        # inside submit() (a full batch never waits; a >= bypass_bytes
        # prompt skips coalescing entirely), and _step_done must find the
        # entry or the page append is silently lost
        rid = self._allocate_rid()
        self._pending[rid] = (session_id, "prefill", step)
        try:
            self._submit(sess, "prefill", PREFILL_OP, PREFILL_SHAPE,
                         max(prompt_bytes, 1), rid=rid)
        except BaseException:
            # admission rejected or shed the prefill synchronously: the
            # session never existed — release its block and forget it
            if self._pending.pop(rid, None) is not None:
                sess.inflight -= 1
            if sess.lease is not None:
                sess.lease.release()
                sess.lease = None
            sess.state = "closed"
            del self._sessions[session_id]
            raise
        self.created += 1
        if self.metrics is not None:
            self.metrics.session_created_total.inc()
        return rid

    def decode(self, session_id: str) -> int:
        """Submit one decode step for a live session. Restores a spilled
        session first (this is the recovery path after preemption or
        migration), grows the KV block when the next page would not fit,
        and routes the step to the pinned replica. The page itself is
        appended at the step's terminal COMPLETION — autoregressive KV is
        produced by executing the step, not by enqueueing it."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.state == "closed":
            raise SessionError(f"no live session {session_id!r}")
        sess.last_active = self._clock()
        self._ensure_resident(sess)
        if sess.retry_steps:
            # a shed step retries its OWN ordinal first; next_step never
            # rewinds, so ordinals still inflight keep exactly one
            # submission each
            step = min(sess.retry_steps)
            sess.retry_steps.discard(step)
            retried = True
        else:
            step = sess.next_step
            sess.next_step += 1
            retried = False
        self._ensure_capacity(sess, (step + 1) * self.config.page_bytes)
        sess.inflight += 1
        # ledger BEFORE submit — see create(): a full batch (the Nth
        # concurrent decode) dispatches and completes inside submit()
        rid = self._allocate_rid()
        self._pending[rid] = (session_id, "decode", step)
        try:
            self._submit(sess, "decode", DECODE_OP, DECODE_SHAPE,
                         MODEL_WIDTH, rid=rid)
        except BaseException:
            if self._pending.pop(rid, None) is not None:
                sess.inflight -= 1
                if retried:
                    sess.retry_steps.add(step)
                else:
                    sess.next_step -= 1
            raise
        return rid

    def close(self, session_id: str):
        """End a session: release its KV lease (resident) or delete its
        spill file (spilled). Idempotent on an already-closed session."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.state == "closed":
            return
        if sess.state == "resident" and sess.lease is not None:
            sess.lease.release()
            sess.lease = None
        elif sess.state == "spilled":
            try:
                os.remove(self._spill_path(session_id))
            except OSError:
                pass
        sess.state = "closed"
        sess.kv_len = 0

    # -- residency: grow / spill / restore / preempt ------------------------
    def _ensure_capacity(self, sess: Session, need: int):
        """Grow the session's KV block to hold ``need`` bytes: lease the
        next size class, copy the committed prefix, release the old block
        — the lease swap is the ONLY copy a session ever pays, and it is
        amortized-rare (power-of-two growth)."""
        if sess.lease is not None and need <= sess.lease.size:
            return
        arena = self._arena(sess.replica_id)
        grown = max(need, 2 * (sess.lease.size if sess.lease else 0))
        fresh = arena.lease(grown)
        if sess.lease is not None:
            if sess.kv_len > 0:
                fresh.view(0, sess.kv_len)[:] = \
                    sess.lease.view(0, sess.kv_len)
            sess.lease.release()
        sess.lease = fresh
        # out-of-order pages live ABOVE kv_len, so the prefix copy missed
        # them; re-materialize or the prefix would later advance over
        # never-written bytes (the grown block always covers them: they
        # were written within the old block and grown >= old size)
        self._rewrite_pending(sess)
        self.kv_grows += 1
        if self.metrics is not None:
            self.metrics.session_kv_grows_total.inc()

    def _rewrite_pending(self, sess: Session):
        """Re-write every out-of-order completed page at its fixed offset
        (``kv_page`` is deterministic, so parked bytes are recomputable).
        Both paths that re-home the cache into a fresh block — the grow
        swap and a restore — copy only the committed prefix and must call
        this, or the advancement loop would later walk ``kv_len`` over
        offsets whose bytes were never rewritten."""
        page = self.config.page_bytes
        for step in sess.pending_pages:
            sess.lease.view(step * page, page)[:] = \
                kv_page(sess.session_id, step, page)

    def _spill_path(self, session_id: str) -> str:
        stem = hashlib.sha256(session_id.encode()).hexdigest()[:24]
        return os.path.join(self.config.spill_dir, f"sess-{stem}.json")

    def _spill(self, sess: Session):
        """Evict one resident session's KV cache to ``sessionSpillDir``:
        serialize the committed prefix (sha256-stamped), write to a
        ``.tmp`` sibling, ``os.replace`` into place — the same atomic
        discipline as the compile-cache spill, so a crash mid-spill
        leaves either the old file or the new one, never a torn doc —
        then release the lease back to the arena."""
        if sess.state != "resident":
            return
        if not self.config.spill_dir:
            raise SessionError(
                "session preemption needs relay.sessions.spillDir — "
                "evicting a KV cache with nowhere to spill would lose it")
        os.makedirs(self.config.spill_dir, exist_ok=True)
        kv = (bytes(sess.lease.view(0, sess.kv_len))  # gpucheck: ignore[payload-copy] -- eviction path, not the per-step hot path: spill serializes the cache exactly once per preemption
              if sess.kv_len else b"")
        doc = {
            "version": _SPILL_VERSION,
            "session_id": sess.session_id,
            "tenant": sess.tenant,
            "steps_done": sess.steps_done,
            "next_step": sess.next_step,
            "kv_len": sess.kv_len,
            "sha256": hashlib.sha256(kv).hexdigest(),
            "kv": base64.b64encode(kv).decode("ascii"),
        }
        path = self._spill_path(sess.session_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        sess.lease.release()
        sess.lease = None
        sess.state = "spilled"
        sess.replica_id = ""
        sess.spills += 1
        self.spills += 1
        if self.metrics is not None:
            self.metrics.session_spills_total.inc()

    def _restore(self, sess: Session):
        """Re-admit a spilled session: lease a block on the (re-)pinned
        replica, copy the KV bytes back, verify the sha — byte-identical
        or ``SessionError`` — and CONSUME the spill file, which is what
        makes a double-restore structurally impossible."""
        if sess.state != "spilled":
            return
        path = self._spill_path(sess.session_id)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise SessionError(
                f"session {sess.session_id!r} spill doc unreadable: {e}")
        kv = base64.b64decode(doc.get("kv", ""))
        if hashlib.sha256(kv).hexdigest() != doc.get("sha256"):
            raise SessionError(
                f"session {sess.session_id!r} spill doc corrupt: KV sha "
                f"mismatch — refusing a non-identical restore")
        sess.replica_id = self._pin(sess.session_id)
        self._make_room(exclude=sess.session_id)
        need = max(len(kv), self.config.page_bytes)
        if sess.pending_pages:
            # the spill doc carries only the committed prefix; parked
            # out-of-order pages must fit too so they can be re-written
            need = max(need, (max(sess.pending_pages) + 1)
                       * self.config.page_bytes)
        sess.lease = self._arena(sess.replica_id).lease(need)
        if kv:
            sess.lease.view(0, len(kv))[:] = kv
        sess.kv_len = int(doc.get("kv_len", len(kv)))
        sess.steps_done = int(doc.get("steps_done", 0))
        self._rewrite_pending(sess)
        sess.state = "resident"
        os.remove(path)
        sess.restores += 1
        self.restores += 1
        if self.metrics is not None:
            self.metrics.session_restores_total.inc()

    def _ensure_resident(self, sess: Session):
        if sess.state == "spilled":
            self._restore(sess)

    def _resident(self) -> list[Session]:
        return [s for s in self._sessions.values()
                if s.state == "resident"]

    def _make_room(self, exclude: str = ""):
        """Enforce the ``maxSessions`` residency bound: while at or over
        it, preempt the least-recently-active resident session (spill —
        recoverable, never lost). ``exclude`` protects the session being
        created or restored from evicting itself."""
        while True:
            resident = [s for s in self._resident()
                        if s.session_id != exclude]
            if len(resident) < self.config.max_sessions:
                return
            victim = min(resident, key=lambda s: (s.last_active,
                                                  s.session_id))
            self._spill(victim)
            self.preempted += 1
            if self.metrics is not None:
                self.metrics.session_preempted_total.inc()

    def preempt(self, session_id: str):
        """Explicitly spill one resident session (tests and operators)."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.state != "resident":
            raise SessionError(f"no resident session {session_id!r}")
        self._spill(sess)
        self.preempted += 1
        if self.metrics is not None:
            self.metrics.session_preempted_total.inc()

    # -- router hooks (tier mode) -------------------------------------------
    def evacuate(self, replica_id: str, service=None) -> int:
        """Migrate every session resident on ``replica_id`` off it via
        spill (the router calls this from ``kill()`` and ``remove()``
        before the handle is discarded). ``service`` is the departing
        replica's service — on a kill it is already off the ring, so the
        arena is reached through the handle the router still holds; this
        models the operator recovering session state from the replica's
        pinned memory before reclaiming the node. Returns how many
        sessions moved."""
        del service  # _spill reads each session's lease directly; the
        # release lands in the departing replica's arena via the lease's
        # own back-pointer, so no handle lookup is needed here
        moved = 0
        for sess in self._sessions.values():
            if sess.state == "resident" and sess.replica_id == replica_id:
                self._spill(sess)
                moved += 1
                self.migrations += 1
                if self.metrics is not None:
                    self.metrics.session_migrations_total.inc()
        return moved

    def pin_of(self, session_id: str) -> str | None:
        """The replica whose arena holds this session's KV cache (the
        router reads this to pin session-tagged routing), or None when
        the session is not resident — the router then routes normally."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.state != "resident":
            return None
        return sess.replica_id or None

    def prepare_resubmit(self, session_id: str) -> str | None:
        """Restore one session ahead of a kill-resubmit of its orphaned
        step, returning the replica the resubmission must pin to (None
        when the session is gone — the step then routes unpinned)."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.state == "closed":
            return None
        self._ensure_resident(sess)
        return sess.replica_id or None

    # -- completion: the page append ----------------------------------------
    def _step_done(self, rid: int, result):
        info = self._pending.pop(rid, None)
        if info is None:
            return
        session_id, kind, step = info
        sess = self._sessions.get(session_id)
        if sess is None or sess.state == "closed":
            return
        sess.inflight = max(0, sess.inflight - 1)
        sess.last_active = self._clock()
        if isinstance(result, Exception):
            # a shed/errored step is terminal but appended nothing; its
            # ordinal parks in retry_steps and the next decode() re-issues
            # it first — next_step never rewinds, because later ordinals
            # may still be inflight and re-issuing those would double the
            # submission (two ledger entries for one step)
            self.shed_steps += 1
            sess.retry_steps.add(step)
            return
        self._append_page(sess, step)
        if kind == "decode":
            self.decode_steps += 1
            if self.metrics is not None:
                self.metrics.session_decode_steps_total.inc()

    def _append_page(self, sess: Session, step: int):
        """Write step ``step``'s page at its fixed offset and advance the
        contiguous committed prefix. Steps normally complete in order
        (EDF within one key is FIFO for same-deadline peers); a step
        completing ahead of a predecessor parks in ``pending_pages``
        until the prefix catches up, so ``kv_len`` only ever covers
        fully-written bytes — what spill serializes is always valid."""
        page = self.config.page_bytes
        self._ensure_resident(sess)
        self._ensure_capacity(sess, (step + 1) * page)
        sess.lease.view(step * page, page)[:] = \
            kv_page(sess.session_id, step, page)
        sess.pending_pages.add(step)
        while sess.steps_done in sess.pending_pages:
            sess.pending_pages.discard(sess.steps_done)
            sess.steps_done += 1
            sess.kv_len = sess.steps_done * page

    # -- pump: idle expiry + gauges ------------------------------------------
    def pump(self, now: float | None = None) -> int:
        """One loop turn: close sessions idle past
        ``idleTimeoutSeconds`` (skipping any with in-flight steps — a
        slow step must not expire its own session) and refresh the
        session gauges. Returns how many sessions expired."""
        if now is None:
            now = self._clock()
        expired = 0
        if self.config.idle_timeout_s > 0:
            for sess in list(self._sessions.values()):
                if sess.state == "closed" or sess.inflight > 0:
                    continue
                if (now - sess.last_active) > self.config.idle_timeout_s:
                    self.close(sess.session_id)
                    expired += 1
                    self.expired += 1
                    if self.metrics is not None:
                        self.metrics.session_expired_total.inc()
        self._refresh_gauges()
        return expired

    def _refresh_gauges(self):
        if self.metrics is None:
            return
        live = resident = kv = 0      # one streaming pass, no containers
        for s in self._sessions.values():
            if s.state == "closed":
                continue
            live += 1
            if s.state == "resident":
                resident += 1
                kv += s.kv_len
        self.metrics.session_live.set(live)
        self.metrics.session_resident.set(resident)
        self.metrics.session_kv_bytes.set(kv)

    # -- observability -------------------------------------------------------
    def session(self, session_id: str) -> Session:
        sess = self._sessions.get(session_id)
        if sess is None:
            raise SessionError(f"unknown session {session_id!r}")
        return sess

    def live_sessions(self) -> list[str]:
        return sorted(s.session_id for s in self._sessions.values()
                      if s.state != "closed")

    def kv_bytes(self, session_id: str) -> bytes:
        """The committed KV prefix of a RESIDENT session (byte-identity
        assertions in tests; restores a spilled session first)."""
        sess = self.session(session_id)
        if sess.state == "closed":
            raise SessionError(f"session {session_id!r} is closed")
        self._ensure_resident(sess)
        return (bytes(sess.lease.view(0, sess.kv_len))  # gpucheck: ignore[payload-copy] -- observability accessor for byte-identity assertions, never called per step
                if sess.kv_len else b"")

    def stats(self) -> dict:
        live = [s for s in self._sessions.values() if s.state != "closed"]
        resident = [s for s in live if s.state == "resident"]
        return {
            "live": len(live),
            "resident": len(resident),
            "spilled": len(live) - len(resident),
            "created": self.created,
            "expired": self.expired,
            "preempted": self.preempted,
            "spills": self.spills,
            "restores": self.restores,
            "migrations": self.migrations,
            "decode_steps": self.decode_steps,
            "kv_grows": self.kv_grows,
            "shed_steps": self.shed_steps,
            "kv_bytes": sum(s.kv_len for s in resident),
        }
