"""Hysteresis / debounce filter for health probe streams.

A copy of ``tpu_operator/health/hysteresis.py`` (it uses no device);
``tests/test_torch_health.py`` drives both copies with one schedule.

A probe result flips the PUBLISHED state only after the raw observation has
held continuously for the corresponding window: ``down_after_s`` of
uninterrupted bad before healthy→unhealthy, ``up_after_s`` of uninterrupted
good before unhealthy→healthy. A flapping probe (bad for less than the
window, then good again) never surfaces — the candidate timer resets on
every contrary observation. This is the property the tests pin across
randomized schedules: the node condition can never flip faster than
the debounce window.
"""

from __future__ import annotations

import time


class _KeyState:
    __slots__ = ("published", "candidate", "since")

    def __init__(self, published: bool):
        self.published = published
        self.candidate = published
        self.since = None  # clock time the current candidate streak began


class Debouncer:
    """Per-key (GPU index or "node") two-threshold debounce.

    Keys start optimistically healthy: a GPU that is bad from the very
    first observation still waits out ``down_after_s`` before being
    published unhealthy — quarantine is expensive, a startup blip is not.
    ``clock`` is injectable so harnesses drive virtual time.
    """

    def __init__(self, down_after_s: float, up_after_s: float,
                 clock=time.monotonic):
        self.down_after_s = max(0.0, float(down_after_s))
        self.up_after_s = max(0.0, float(up_after_s))
        self.clock = clock
        self._keys: dict = {}

    def observe(self, key, healthy: bool) -> bool:
        """Feed one raw observation; returns the published (debounced)
        state for ``key``."""
        now = self.clock()
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _KeyState(published=True)
        if healthy == st.published:
            # agreement cancels any pending flip
            st.candidate = st.published
            st.since = None
            return st.published
        if healthy != st.candidate:
            # a NEW contrary streak starts now
            st.candidate = healthy
            st.since = now
        window = self.up_after_s if healthy else self.down_after_s
        if st.since is not None and now - st.since >= window:
            st.published = healthy
            st.candidate = healthy
            st.since = None
        return st.published

    def published(self, key) -> bool:
        st = self._keys.get(key)
        return True if st is None else st.published

    def keys(self) -> list:
        """Every key ever observed (and not forgotten) — lets the monitor
        notice a GPU that stopped being reported by any probe."""
        return list(self._keys)

    def forget(self, key):
        self._keys.pop(key, None)
