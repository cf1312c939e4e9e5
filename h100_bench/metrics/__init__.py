"""The per-layer metrics: one file a metric, ``<metric name>.py``, with a
``read(trace)`` that returns the metric's value from a traced window
(harness.Trace), or None where the trace holds nothing to read.  The
arithmetic they share is here."""

from __future__ import annotations

from h100_bench import peaks


def roofline(t, work) -> float | None:
    """A kernel's share of its roofline over the traced window: the least
    time its work (``work.per_frame``) takes at the card's peaks, for every
    frame, over the time its device kernels (``work.KERNELS``) took; None
    where the trace holds none of them."""
    spent = t.seconds(work.KERNELS)
    if not spent:
        return None
    flops, nbytes = work.per_frame(t.cfg, t.mix)
    return 100.0 * peaks.bound_seconds(flops, nbytes) * t.units / spent


def idle_share(t) -> float | None:
    """100 x (1 - device busy / traced window); None without device ops."""
    if not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
