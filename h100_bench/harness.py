"""The benchmark's runner: one cell, one run, one result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, whose
``generator`` names the code that plays it, ``traffic/<generator>.py``),
its chips and the limits of its correctness check.  ``BENCHMARK.json`` at
the checkout's root names the metrics; each per-layer metric is read by
``metrics/<metric>.py`` from the traced run.  So a configuration, a mix, a
cell or a metric is added by adding files.

A generator's ``run(run)`` takes a :class:`Run` and returns an
:class:`Outcome`: its end-to-end metrics, the numbers its check compared
with their limits, and with tracing the :class:`Trace` of its window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
#: names whose modules the benchmark process may not hold: the reference
#: package of the port and its libraries (top-level names, whole words)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rvdd_tpu"})
#: prefix of the harness's own profiler spans
SPAN = "h100b."
#: the cores this process may run on, as it started
CORES = tuple(sorted(os.sched_getaffinity(0)))
#: cores a card's process runs on (pin_cores)
CORES_PER_CARD = 4


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file by its path (metric files carry dots in their names)."""
    name = f"h100b_{path.parent.name}_{path.stem.replace('.', '_')}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def benchmark_json(root: Optional[Path] = None) -> dict:
    with open((root or HERE.parent) / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that are
    FORBIDDEN, compared whole: ``rvdd_tpu_torch`` is not ``rvdd_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)


def card_info() -> str:
    """`name, power limit` of the first card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


# ------------------------------------------------------------------ tracing


@dataclasses.dataclass
class Trace:
    """A traced window, as the per-layer metrics read it.  Times in
    seconds, on the profiler's clock.

    ``kernels``: (name, start, end) of every device op but the profiler's
    copies of host spans; ``device_spans``: those copies, by span name, as
    (start, end) on the device timeline; ``host_spans``: (name, start, end)
    of the harness's spans on the host; ``window``: (start, end) of the
    traced window; ``units``: frames or steps in it; ``cfg``, ``mix``: the
    cell's configuration and traffic mix; ``cards``: the cards that shared
    the work (this trace is one card's)."""

    kernels: List[Tuple[str, float, float]]
    device_spans: Dict[str, List[Tuple[float, float]]]
    host_spans: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    units: int
    cfg: dict
    mix: dict
    cards: int = 1

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self, kernels=None) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals inside the window."""
        a0, b0 = self.window
        iv = sorted((max(s, a0), min(e, b0)) for _, s, e in (kernels or self.kernels)
                    if e > a0 and s < b0)
        out: List[List[float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def matching(self, substrings) -> list:
        """The kernels whose names contain any of ``substrings``."""
        return [k for k in self.kernels if any(s in k[0] for s in substrings)]

    def seconds(self, substrings) -> float:
        return sum(e - s for _, s, e in self.matching(substrings))

    def under(self, span: str) -> list:
        """The kernels that started inside the device copies of ``span``."""
        spans = self.device_spans.get(span, [])
        return [k for k in self.kernels if any(a <= k[1] < b for a, b in spans)]

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (by name), and the idle time
        on the device by the harness span open on the host meanwhile."""
        ops: Dict[str, float] = {}
        for name, s, e in self.kernels:
            key = _op_name(name)
            ops[key] = ops.get(key, 0.0) + (e - s)
        gaps: Dict[str, List[float]] = {}
        edge = self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if s > edge:
                name = self._host_span_over(edge, s)
                g = gaps.setdefault(name, [0.0, 0])
                g[0] += s - edge
                g[1] += 1
            edge = max(edge, e)
        return {
            "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[f"{k} ({n} gaps)", v] for k, (v, n) in
                          sorted(gaps.items(), key=lambda kv: -kv[1][0])[:top]],
        }

    def _host_span_over(self, a: float, b: float) -> str:
        best, name = 0.0, "outside the harness's spans"
        for span, s, e in self.host_spans:
            if span == SPAN + "window":
                continue
            overlap = min(b, e) - max(a, s)
            if overlap > best:
                best, name = overlap, span
        return name


def _op_name(name: str) -> str:
    """A device op's name for the breakdown: PyTorch's own kernels with
    their functor (which says what they do), the others by the function's
    name alone: no return type, template arguments or parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    if name.startswith("at::native::"):
        return name[:96]
    short = name
    while True:
        cut = re.sub(r"<[^<>]*>|\([^()]*\)", "", short)
        if cut == short:
            break
        short = cut
    words = short.split()
    return (words[-1].strip(":") if words else name)[:96] or name[:96]


def trace_from_profile(prof, units: int, cfg: dict, mix: dict, cards: int = 1) -> Trace:
    """Read a torch.profiler run whose traced window is the host span
    ``h100b.window``."""
    import torch

    kernels, device_spans, host_spans = [], {}, []
    window = None
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith(SPAN):
            if on_device:
                device_spans.setdefault(e.name, []).append((s, t))
            elif e.name == SPAN + "window":
                window = (s, t)
            else:
                host_spans.append((e.name, s, t))
        elif on_device and not e.is_user_annotation:
            kernels.append((e.name, s, t))
    if window is None:
        raise RuntimeError("the trace has no h100b.window span")
    return Trace(kernels, device_spans, host_spans, window, units, cfg, mix, cards)


# --------------------------------------------------------------------- runs


@dataclasses.dataclass
class Run:
    """What a generator is asked to do.  ``variant`` is None for the
    program as the configuration states it, ``"control"`` for the cell's
    control, or ``"fault:<name>"`` for a planted fault (the calibration
    and the harness's tests use them; the benchmark's runs never do)."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    variant: Optional[str] = None
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """``metrics``: end-to-end name -> value; ``attempted``/``failed``:
    frames or steps; ``checks``: compared name -> (value, limit);
    ``readings``: every number the check computed (the compared ones and
    those kept only for calibration); ``trace``: the traced window;
    ``memory_peak_bytes``, ``count``: of the fullest card, cards used."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    readings: Dict[str, float]
    memory_peak_bytes: int
    count: int = 1
    trace: Optional[Trace] = None
    per_rank_busy: Optional[List[Tuple[float, float]]] = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())


def judge(readings: Dict[str, float], cell: dict) -> Dict[str, Tuple[float, float]]:
    """The compared numbers with their limits.  A reading that is missing
    or not a number (the check crashed, or gave NaN) fails."""
    out = {}
    for name, lim in cell["limits"].items():
        v = readings.get(name, float("inf"))
        out[name] = (float("inf") if v != v else float(v), float(lim))
    return out


def generator(mix: dict):
    return load_module(HERE / "traffic" / f"{mix['generator']}.py")


def make_run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, variant: Optional[str] = None,
             mix_overrides: Optional[dict] = None) -> Run:
    cell = load_json("workloads", cell_name)
    cfg = load_json("configs", cell["config"])
    mix = dict(load_json("traffic", cell["traffic"]), **(mix_overrides or {}))
    kw = {} if t_start is None else {"t_start": t_start}
    return Run(cell, cfg, mix, seed, seconds, trace, device, variant=variant, **kw)


def per_layer(run: Run, trace: Trace, bench: dict) -> Dict[str, dict]:
    """The per-layer metrics of BENCHMARK.json that this cell reports, each
    read by its own file; a reader that finds nothing returns None and the
    metric is left out."""
    name = run.cell["name"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    mine = {m for m, spec in e2e.items() if name in spec.get("workloads", [name])}
    out = {}
    for spec in bench["per_layer"]:
        cells = spec.get("workloads")
        if (name not in cells) if cells is not None else (spec["moves"] not in mine):
            continue
        value = load_module(HERE / "metrics" / f"{spec['name']}.py").read(trace)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def result(run: Run, outcome: Outcome, bench: dict) -> dict:
    """The contract's last line (``checks`` comes last)."""
    import torch

    if run.trace:
        metrics = per_layer(run, outcome.trace, bench)
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in outcome.metrics.items()
                   if k in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": outcome.count,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if run.trace:
        busy = outcome.per_rank_busy or [(outcome.trace.busy_s, outcome.trace.window_s)]
        device["busy_s"] = sum(b for b, _ in busy) / len(busy)
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def main(args, t_start: float) -> int:
    """One run of one cell on the card; prints the result line last on
    standard output and the compared numbers last on standard error."""
    import torch

    run = make_run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: {args.workload} needs {chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    bench = benchmark_json()
    outcome = generator(run.mix).run(run)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: the benchmark process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result(run, outcome, bench)
    from rvdd_tpu_torch import _build

    print(f"card {card_info()}", file=sys.stderr)
    for name, info in _build.BUILD_INFO.items():
        print(f"built {name} in {info['seconds']:.1f} s", file=sys.stderr)
    print(f"correct {line['correct']} attempted {line['attempted']} failed {line['failed']}",
          file=sys.stderr)
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def cores_of(rank: int = 0, cores=CORES, visible: Optional[str] = None,
             machine: Optional[int] = None) -> Optional[tuple]:
    """The CORES_PER_CARD cores the process of ``rank`` runs on, from the
    third of ``cores`` on.  On the whole machine (``cores`` is every core
    it has) the block follows the card the process drives, the ``rank``-th
    of ``visible`` (CUDA_VISIBLE_DEVICES; every card where unset), so runs
    on different cards of one machine never share a core.  A process given
    fewer cores than the machine has, or cards named by UUID, takes the
    ``rank``-th block of its own cores.  None where the block does not fit."""
    machine = os.cpu_count() if machine is None else machine
    card = rank
    ids = [v.strip() for v in (visible or "").split(",") if v.strip()]
    if len(cores) >= (machine or 0) and rank < len(ids) and ids[rank].isdigit():
        card = int(ids[rank])
    first = 2 + CORES_PER_CARD * card
    mine = tuple(cores[first:first + CORES_PER_CARD])
    return mine if len(mine) == CORES_PER_CARD else None


def pin_cores(rank: int = 0, cores=CORES) -> None:
    """Run this process on cores of its own (:func:`cores_of`): the card's
    launches come from one host thread, so the frame and step times follow
    the host, and runs that migrate between all the machine's cores spread
    twice as wide (PERF.md).  Where no block fits, the process stays as it
    started."""
    mine = cores_of(rank, cores, os.environ.get("CUDA_VISIBLE_DEVICES"))
    if mine:
        os.sched_setaffinity(0, mine)


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program builds its kernels into its own ``_build/`` there; Triton
    and torch's extension builder, if anything reaches them, under
    ``.bench_cache/``."""
    cache = HERE.parent / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
