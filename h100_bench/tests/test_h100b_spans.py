"""spans.py: the program's spans read from a trace, the launches and idle
gaps put under them (synthetic events, two threads), the readings'
arithmetic, and that the harness's Trace, so every metric, reads the same
with the program's spans in the trace as without them."""

import types

import pytest
import torch

from h100_bench import harness, spans

from conftest import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, device, start, end, eid=0, thread=1, annotation=False):
    """A profiler event (times in us, as FunctionEvent's)."""
    return types.SimpleNamespace(name=name, device_type=device, id=eid, thread=thread,
                                 is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def kernel(name, eid, launch, start, end, thread=1):
    """A kernel's launch call on the host and the kernel on the device."""
    call = "cuLaunchKernelEx" if "nccl" in name else "cudaLaunchKernel"
    return [ev(call, CPU, launch, launch + 1, eid, thread), ev(name, CUDA, start, end, eid)]


def step_events(program: bool = True):
    """One train step of a traced window, 0-100 us: the main thread (1)
    opens forward then backward, the autograd engine's thread (2) opens an
    exchange inside the backward; the harness's spans around it."""
    out = [ev("h100b.window", CPU, 0, 100, annotation=True),
           ev("h100b.train_step", CPU, 1, 95, annotation=True),
           ev("h100b.train_step", CUDA, 5, 90, annotation=True)]
    if program:
        out += [ev("rvdd.train.forward", CPU, 2, 30, 901), ev("rvdd.step", CPU, 3, 29, 902),
                ev("rvdd.train.backward", CPU, 30, 80, 903),
                ev("rvdd.space.window", CPU, 40, 60, 904, thread=2),
                ev("rvdd.train.optimizer", CPU, 80, 94, 905)]
    out += kernel("conv_fwd", 1, 4, 5, 15)
    out += kernel("elementwise", 2, 20, 25, 28)
    out += [ev("cudaMemcpyAsync", CPU, 21, 22, 3), ev("Memcpy DtoH", CUDA, 28, 29, 3)]
    out += kernel("ncclDevKernel_AllGather", 4, 45, 46, 55, thread=2)
    out += kernel("conv_dgrad", 5, 62, 63, 75, thread=2)
    out += kernel("adamw", 6, 85, 86, 90)
    out += [ev("lost_kernel", CUDA, 91, 92, 7)]
    return out


def test_read_and_launches_under_spans_across_threads():
    sp = spans.read(step_events())
    assert [s[0] for s in sp.spans] == ["h100b.train_step", "rvdd.train.forward", "rvdd.step",
                                        "rvdd.train.backward", "rvdd.space.window",
                                        "rvdd.train.optimizer"]
    assert [(k[0], k[3] and round(k[3] * 1e6, 9)) for k in sp.launches] == [
        ("conv_fwd", 4), ("elementwise", 20), ("Memcpy DtoH", 21),
        ("ncclDevKernel_AllGather", 45), ("conv_dgrad", 62), ("adamw", 85),
        ("lost_kernel", None)]
    names = {k: [sp.launches[i][0] for i in v] for k, v in spans.launches_under(sp).items()}
    assert names == {"rvdd.train.forward": ["conv_fwd", "elementwise"],
                     "rvdd.step": ["conv_fwd", "elementwise"],
                     "rvdd.train.backward": ["ncclDevKernel_AllGather", "conv_dgrad"],
                     "rvdd.space.window": ["ncclDevKernel_AllGather"],
                     "rvdd.train.optimizer": ["adamw"],
                     "no launch call": ["lost_kernel"]}
    harness_only = spans.launches_under(sp, "h100b.")
    assert len(harness_only["h100b.train_step"]) == 5  # launched in 1-95 us, copies left out


def test_idle_gaps_go_to_the_innermost_span_open_at_their_midpoint():
    sp = spans.read(step_events())
    busy = [(5e-6, 1.5e-5), (4.6e-5, 5.5e-5), (6.3e-5, 7.5e-5)]
    idle = spans.idle_by_span(sp, busy, (0.0, 1e-4))
    got = {k: (round(v * 1e6, 6), n) for k, (v, n) in idle.items()}
    # 0-5: midpoint 2.5 in forward; 15-46: midpoint 30.5 in backward; 55-63:
    # 59 in the backward thread's window; 75-100: 87.5 in the optimizer
    assert got == {"rvdd.train.forward": (5.0, 1), "rvdd.train.backward": (31.0, 1),
                   "rvdd.space.window": (8.0, 1), "rvdd.train.optimizer": (25.0, 1)}
    assert spans.idle_by_span(spans.read(step_events(False)), busy, (0.0, 1e-4)) == {
        spans.OUTSIDE: (pytest.approx(1e-4 - 3.1e-5), 4)}


def test_split_readings_a_unit():
    events = step_events()
    trace = harness.trace_from_profile(types.SimpleNamespace(events=lambda: events), 2, {}, {})
    out = spans.split(spans.read(events), trace)
    assert out["units"] == 2 and out["launches_per_unit"] == 3.0  # 6 kernels, no copy
    assert (out["forward_launches.train"], out["backward_launches.train"],
            out["optimizer_launches.train"], out["reduce_launches.train"]) == (1.0, 1.0, 0.5, 0)
    assert out["exchange_ms_per_step.space"] == pytest.approx(1e3 * 9e-6 / 2)
    assert out["nccl_ms_per_unit"] == pytest.approx(out["exchange_ms_per_step.space"])
    assert out["launches"]["no launch call"] == 0.5
    assert out["rest"] == [["lost_kernel", 0.5]]


def _profile_events(program: bool):
    """A stream frame's events, with or without the program's spans."""
    out = [ev("h100b.window", CPU, 0, 100, annotation=True),
           ev("h100b.prepare", CPU, 1, 40, annotation=True),
           ev("h100b.prepare", CUDA, 6, 45, annotation=True),
           ev("h100b.step", CPU, 41, 90, annotation=True),
           ev("h100b.step", CUDA, 50, 95, annotation=True)]
    if program:
        out += [ev("rvdd.prepare_frames", CPU, 2, 39, 900), ev("rvdd.demosaic", CPU, 3, 30, 901),
                ev("rvdd.step", CPU, 42, 89, 902), ev("rvdd.chains", CPU, 50, 88, 903)]
    out += kernel("at::native::index_select", 1, 5, 6, 30)
    out += kernel("at::native::elementwise", 2, 31, 32, 45)
    out += kernel("warp_bicubic_kernel_wide", 3, 45, 50, 60)
    out += kernel("void ws::ws_layer_kernel<3, 1>(Params)", 4, 55, 61, 95)
    return out


def test_every_metric_reads_the_same_with_the_program_spans():
    """The program's spans are host-side op-scope events: the harness's
    Trace, its breakdown and every per-layer metric read the same with them
    as without them."""
    bench = harness.benchmark_json()
    for spec in bench["per_layer"]:
        cell = harness.load_json("workloads", spec["workloads"][0])
        cfg, mix = harness.load_json("configs", cell["config"]), harness.load_json(
            "traffic", cell["traffic"])
        got = []
        for program in (False, True):
            events = _profile_events(program)
            t = harness.trace_from_profile(types.SimpleNamespace(events=lambda: events), 1,
                                           cfg, mix)
            got.append((t, t.breakdown(),
                        harness.load_module(harness.HERE / "metrics" / f"{spec['name']}.py")
                        .read(t)))
        assert got[0] == got[1], spec["name"]


def test_a_traced_cpu_run_carries_the_program_spans(monkeypatch):
    """The tiny stream cell traced on the CPU: every frame's
    ``rvdd.prepare_frames`` (with its demosaic and flow upsample) inside
    the harness's ``h100b.prepare``, and its ``rvdd.step``."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    held = {}
    read_trace = harness.trace_from_profile

    def keep(prof, *a, **k):
        held["spans"] = spans.read(prof.events())
        return read_trace(prof, *a, **k)

    monkeypatch.setattr(harness, "trace_from_profile", keep)
    cell = "convunet_ff.stream"
    r = harness.make_run(cell, 11, 0.2, True, "cpu", mix_overrides=tiny(cell))
    out = harness.generator(r.mix).run(r)
    sp = held["spans"]
    n = {}
    for s in sp.spans:
        n[s[0]] = n.get(s[0], 0) + 1
    frames = out.trace.units
    for name in ("h100b.prepare", "rvdd.prepare_frames", "rvdd.demosaic", "rvdd.flow_upsample",
                 "h100b.step", "rvdd.step", "rvdd.warp", "rvdd.chains"):
        assert n[name] == frames, name
    prepare = [s for s in sp.spans if s[0] == "h100b.prepare"]
    for s in sp.spans:
        if s[0] == "rvdd.prepare_frames":
            assert any(p[2] <= s[2] and s[3] <= p[3] for p in prepare)
    assert spans.split(sp, out.trace)["launches_per_unit"] == 0  # no device on the CPU
