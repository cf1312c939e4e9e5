"""Spans at the port's layer boundaries, for torch.profiler traces.

    with tracing.span("prepare_frames"):
        ...

While a torch profiler records, :func:`span` opens a profiler range named
``rvdd.<name>``: an event of the profiler's own, on the clock of its device
trace, so every trace of the port carries them (``bench --trace_dir`` and
``--profile``, the trainer's ``--profile_dir``, the benchmark's traced
runs).  Otherwise it returns one shared no-op context: one flag check, no
range opened (about 0.5 us a span, against about 11 us for an ungated
``record_function``; NVIDIA H100's host, torch 2.11).

The range is an op-scope range (torch's ``_RecordFunctionFast``), not a
``record_function`` (a user annotation): CUPTI tags each kernel with the
innermost user annotation open at its launch alone, so a user annotation
here would take the kernels launched inside it off the device-timeline copy
of a caller's own ``record_function`` around a call into the port.  An
op-scope range leaves those copies as they are, and costs about 1.3 us
under the profiler against 11 for a ``record_function`` (same host).  It
has no device-timeline copy of its own, so a span's kernels are read on the
host side (:func:`launched_inside`): a kernel belongs to every span whose
host interval holds its launch call, on any thread, so a span of the
autograd engine's thread holds the kernels that thread launched.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch.autograd import profiler as _profiler

#: the prefix of every span's name
PREFIX = "rvdd."


class _Off:
    """The context :func:`span` returns without a profiler: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A profiler range ``rvdd.<name>`` while a torch profiler records,
    else a no-op context."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF


def _launch_starts(events) -> dict:
    """Correlation id -> start of the host calls that launch device work:
    the CUDA API's (``cuda*``, ``cu*``), whose events share their id with
    the kernel or copy they launched."""
    cpu = torch.autograd.DeviceType.CPU
    return {e.id: e.time_range.start for e in events
            if e.device_type == cpu and e.name.startswith("cu") and not e.is_user_annotation}


def launched_inside(events, kernels: Sequence, name: str) -> List[bool]:
    """For each of ``kernels`` (device events of a profiler's ``events``),
    whether the host call that launched it started inside a span ``name``
    (on any thread); False where the trace holds no such call."""
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == name and e.device_type == cpu]
    starts = _launch_starts(events)
    out = []
    for k in kernels:
        t = starts.get(k.id)
        out.append(t is not None and any(a <= t < b for a, b in spans))
    return out
