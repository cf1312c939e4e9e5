"""The program's own spans in a traced window, and the launches and idle
time they hold.

The program opens ``rvdd.*`` spans at its layer boundaries
(``rvdd_tpu_torch/tracing.py``): profiler ranges on the host, op-scope, with
no device-timeline copy.  :func:`read` takes them from a torch.profiler run,
with each device kernel's host launch time (the start of the CUDA API
call, ``cuda*`` or ``cu*``, whose correlation id the kernel carries), and
:func:`split` divides the window among them:

* a kernel belongs to every span whose host interval holds its launch, on
  any thread, so a kernel launched by the autograd engine's thread belongs
  to the main thread's ``rvdd.train.backward`` and to any span that thread
  opened; a span's count holds its nested spans' kernels;
* an idle gap of the device belongs to the innermost span open on the host
  at the gap's midpoint: the latest-started span that holds it, on any
  thread.

Launches are counted as ``launches_per_step.train`` counts them: device
kernels, memory copies and sets left out.  The harness's ``Trace`` does not
carry these spans (a benchmark change would add them to
``harness.trace_from_profile``), so this script runs a cell's traced run
itself and reads them:

    python3 h100_bench/spans.py --workload <cell> --seed <n> --seconds 20

prints run.py's ``--trace 1`` result line last on standard output and,
before it on standard error, one line a program span (``launches by
program span <name> <a unit>``, ``idle by program span <name> <ms a unit>
(<gaps>)``) and one JSON line ``program spans {...}`` with the readings
(``split``) and the window's traced end-to-end metrics.  Without the
program's spans (an older checkout) every launch and gap falls outside.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402

#: prefix of the program's spans
PROGRAM = "rvdd."
#: where a launch or a gap under no program span is put
OUTSIDE = "outside the program's spans"


@dataclasses.dataclass
class Spans:
    """``spans``: (name, thread, start, end) of the program's spans and the
    harness's (``h100b.*``, the window left out) on the host;
    ``launches``: (name, start, end, launch) of every device op that
    ``harness.trace_from_profile`` keeps as a kernel, launch None where the
    trace holds no launch call for it.  Seconds, on the profiler's clock."""

    spans: List[Tuple[str, int, float, float]]
    launches: List[Tuple[str, float, float, Optional[float]]]


def read(events) -> Spans:
    """The spans and launches of a torch.profiler run's ``events()``."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    calls, spans, device = {}, [], []
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            if not e.name.startswith(harness.SPAN) and not e.is_user_annotation:
                device.append((e.name, s, t, e.id))
        elif e.device_type == cpu:
            if e.name.startswith(PROGRAM) or (e.name.startswith(harness.SPAN)
                                              and e.name != harness.SPAN + "window"):
                spans.append((e.name, e.thread, s, t))
            elif e.name.startswith("cu") and not e.is_user_annotation:
                calls[e.id] = s
    return Spans(spans, [(n, s, t, calls.get(i)) for n, s, t, i in device])


def is_launch(name: str) -> bool:
    """A kernel, as ``launches_per_step.train`` counts them."""
    return not name.startswith(("Memcpy", "Memset"))


def _sweep(spans, times: Sequence[float]) -> List[list]:
    """For each of ``times`` (sorted), the spans open then, by start."""
    order = sorted(spans, key=lambda sp: sp[2])
    out, open_, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][2] <= t:
            open_.append(order[i])
            i += 1
        open_ = [sp for sp in open_ if sp[3] > t]
        out.append(list(open_))
    return out


def launches_under(sp: Spans, prefix: str = PROGRAM) -> Dict[str, List[int]]:
    """Span name -> the indices (into ``sp.launches``) of the kernels
    launched inside a span of that name (nested spans' included), for the
    spans whose names start with ``prefix``; the kernels under none of them
    under OUTSIDE, those without a launch call under ``"no launch call"``."""
    mine = [s for s in sp.spans if s[0].startswith(prefix)]
    idx = sorted((i for i, k in enumerate(sp.launches) if k[3] is not None and is_launch(k[0])),
                 key=lambda i: sp.launches[i][3])
    out: Dict[str, List[int]] = {}
    for i, open_ in zip(idx, _sweep(mine, [sp.launches[i][3] for i in idx])):
        for name in {s[0] for s in open_} or {OUTSIDE}:
            out.setdefault(name, []).append(i)
    lost = [i for i, k in enumerate(sp.launches) if k[3] is None and is_launch(k[0])]
    if lost:
        out["no launch call"] = lost
    return out


def idle_by_span(sp: Spans, busy: List[Tuple[float, float]],
                 window: Tuple[float, float]) -> Dict[str, Tuple[float, int]]:
    """Span name -> (idle seconds, gaps): the device's idle gaps in
    ``window`` between the ``busy`` intervals (sorted, disjoint), each put
    on the innermost program span open at its midpoint, or OUTSIDE."""
    gaps, edge = [], window[0]
    for s, e in list(busy) + [(window[1], window[1])]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    mine = [s for s in sp.spans if s[0].startswith(PROGRAM)]
    out: Dict[str, Tuple[float, int]] = {}
    for (a, b), open_ in zip(gaps, _sweep(mine, [(a + b) / 2 for a, b in gaps])):
        name = max(open_, key=lambda s: s[2])[0] if open_ else OUTSIDE
        v, n = out.get(name, (0.0, 0))
        out[name] = (v + b - a, n + 1)
    return out


def split(sp: Spans, trace: harness.Trace) -> dict:
    """The readings of a traced window (a unit: a frame or a step): the
    per-layer readings under their metric names, the launches a unit under every
    program span and outside them, and the idle ms a unit and gaps by
    innermost program span."""
    u = trace.units
    under = launches_under(sp)
    every = [k for k in sp.launches if is_launch(k[0])]

    def count(name):
        return len(under.get(name, [])) / u

    harness_prepare = launches_under(sp, harness.SPAN + "prepare").get(harness.SPAN + "prepare")
    nccl = {i for name, ids in under.items() if name.startswith(PROGRAM + "space.")
            for i in ids if "nccl" in sp.launches[i][0]}
    rest: Dict[str, int] = {}
    for i in under.get(OUTSIDE, []) + under.get("no launch call", []):
        key = harness._op_name(sp.launches[i][0])
        rest[key] = rest.get(key, 0) + 1
    return {
        "units": u,
        "launches_per_unit": len(every) / u,
        "prepare_launches.stream": count(PROGRAM + "prepare_frames"),
        "h100b.prepare_launches": len(harness_prepare or []) / u,
        "forward_launches.train": count(PROGRAM + "train.forward"),
        "backward_launches.train": count(PROGRAM + "train.backward"),
        "optimizer_launches.train": count(PROGRAM + "train.optimizer"),
        "reduce_launches.train": count(PROGRAM + "train.reduce"),
        "exchange_ms_per_step.space": 1e3 * sum(sp.launches[i][2] - sp.launches[i][1]
                                                for i in nccl) / u,
        "nccl_ms_per_unit": 1e3 * trace.seconds(("nccl",)) / u,
        "launches": {k: len(v) / u for k, v in sorted(under.items())},
        "rest": sorted(([k, n / u] for k, n in rest.items()), key=lambda kv: -kv[1])[:8],
        "idle": {k: [1e3 * v / u, n] for k, (v, n) in
                 sorted(idle_by_span(sp, trace.busy_intervals(), trace.window).items(),
                        key=lambda kv: -kv[1][0])},
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    harness.pin_cores()
    harness.set_cache_dirs()
    import torch

    run = harness.make_run(args.workload, args.seed, args.seconds, True, "cuda", T_START)
    if torch.cuda.device_count() < int(run.cell["chips"]):
        print(f"spans: {args.workload} needs {run.cell['chips']} CUDA card(s)", file=sys.stderr)
        return 3
    read_trace = harness.trace_from_profile
    held: dict = {}

    def keep(prof, *a, **k):  # the program's spans of this process's (rank 0's) window
        held["spans"] = read(prof.events())
        return read_trace(prof, *a, **k)

    harness.trace_from_profile = keep
    try:
        outcome = harness.generator(run.mix).run(run)
    finally:
        harness.trace_from_profile = read_trace
    line = harness.result(run, outcome, harness.benchmark_json())
    out = split(held["spans"], outcome.trace)
    for name, n in out["launches"].items():
        print(f"launches by program span {name} {n:.1f}", file=sys.stderr)
    for name, (ms, gaps) in out["idle"].items():
        print(f"idle by program span {name} {ms:.3f} ({gaps})", file=sys.stderr)
    out["traced"] = outcome.metrics
    out["card"] = harness.card_info()
    print("program spans " + json.dumps(out), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
