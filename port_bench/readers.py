"""What the metric readers share: a reader takes the run's record
(:class:`port_bench.harness.Run`) and returns its metric, or None where the
record holds nothing to read it from (no trace, no span, a card without
published peaks). A share of a roofline or a peak is never returned as 0
for want of data, and never clipped."""

from __future__ import annotations

from port_bench import peaks


def span_mean(run, name: str, scale: float = 1.0):
    mean = run.mean(name)
    return None if mean is None else mean * scale


def idle_percent(run):
    """The share of the traced window, in %, in which no operation ran on
    the device, averaged over the cards the run uses."""
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_mean_s(run.devices) / t.window_s)


def roofline_percent(run, span: str, work_per_span: float, peak: str):
    """The least time ``work_per_span`` of each traced ``span`` could take at
    the card's ``peak``, over the device time of every operation launched
    inside those spans, in %."""
    t, card = run.trace, peaks.card(run.kind)
    if t is None or card is None or not card.get(peak):
        return None
    seconds = sum(op.seconds for op in t.under(span))
    count = t.count(span)
    if seconds <= 0 or count == 0:
        return None
    return 100.0 * count * work_per_span / card[peak] / seconds
