"""The port's spans (rvdd_tpu_torch/tracing.py) on the CPU.

* Without a profiler, ``prepare_frames``, the module and fused steps and a
  train step open no range with an ``rvdd.`` name (torch's own ranges, such
  as ``Optimizer.step``'s, are not counted); under one they do.
* Under a CPU torch.profiler, the spans of that run nest as the engine and
  the train step open them, and on a ``data1xspace2`` mesh of two gloo
  processes the space axis's exchanges open their spans in the backward
  too, inside ``rvdd.train.backward``; the same run holds the byte counters
  ``space.all_gather.bytes`` and ``space.all_sum.bytes`` to the rows a
  ``halo`` must move, counted by hand.
* ``_is_profiler_enabled``, which the no-op path reads, flips under
  ``torch.profiler.profile``, and the op-scope range the spans open exists
  and is no user annotation: a torch upgrade that drops either fails here.
* bench's ``--profile`` groups the solver's kernels by their launch inside
  ``rvdd.flows`` (synthetic events).
"""

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rvdd_tpu_torch import bench, tracing  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _run_paths():
    """prepare_frames and a module step of convunet+feat+future (raw 16x16),
    its fused step, and one train step (2 unrollings)."""
    torch.manual_seed(0)
    cfg, net, _ = bench.make_model("module", seed=0, device="cpu", model="convunet+feat+future")
    raw = torch.rand(1, 3, 16, 16, 4) * 2 - 1
    fl = torch.rand(1, 1, 2, 16, 16, 2)
    frames, flows = engine.prepare_frames(cfg, raw, fl)
    nil = net.nil_features(1, 32, 32)
    with torch.no_grad():
        engine.inference_step(cfg, net, None, frames, flows[:, 0], nil)
        fcfg, fnet, packed = bench.make_model("fused", seed=0, device="cpu",
                                              model="convunet+feat+future")
        engine.inference_step(fcfg, fnet, None, frames, flows[:, 0], None, packed)
    _, state, step, inputs = bench.train_setup("convunet+feat+future", 1, 16, 2, device="cpu")
    step(state, *inputs)


def _spans(events):
    """(name, thread, start, end) of the ``rvdd.*`` spans, by start."""
    return sorted(((e.name, e.thread, e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith(tracing.PREFIX)), key=lambda s: s[2])


def _inside(inner, outer) -> bool:
    return outer[2] <= inner[2] and inner[3] <= outer[3] and inner is not outer


def _parents(spans, name):
    """The names of the spans that hold each span ``name`` (any thread)."""
    return [{o[0] for o in spans if _inside(s, o)} for s in spans if s[0] == name]


def test_profiler_flag_flips_under_profile():
    assert autograd_profiler._is_profiler_enabled is False
    assert tracing.span("x") is tracing.span("y")  # the shared no-op
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(tracing.span("x"), torch._C._profiler._RecordFunctionFast)
    assert autograd_profiler._is_profiler_enabled is False


def test_span_is_an_op_scope_range_of_the_profiler():
    """An op-scope range: under the profiler an event ``rvdd.<name>`` that
    is no user annotation, holding what ran inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(8).sum()
    by = {e.name: e for e in prof.events() if e.name.startswith("rvdd.")}
    assert set(by) == {"rvdd.outer", "rvdd.inner"}
    assert not by["rvdd.outer"].is_user_annotation
    assert [c.name for c in by["rvdd.outer"].cpu_children] == ["rvdd.inner"]
    assert any(c.name == "aten::sum" for c in by["rvdd.inner"].cpu_children)


def test_no_span_opened_without_a_profiler(monkeypatch):
    names = []
    fast, rf = torch._C._profiler._RecordFunctionFast, autograd_profiler.record_function

    def fast_rec(name, *a, **k):
        names.append(name)
        return fast(name, *a, **k)

    class RecRF(rf):
        def __init__(self, name, *a, **k):
            names.append(name)
            super().__init__(name, *a, **k)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast_rec)
    monkeypatch.setattr(autograd_profiler, "record_function", RecRF)
    _run_paths()
    assert [n for n in names if n.startswith("rvdd.")] == []
    assert any(n.startswith("Optimizer.step") for n in names)  # torch's own, left out
    with profile(activities=[ProfilerActivity.CPU]):
        _run_paths()
    assert {"rvdd.prepare_frames", "rvdd.step", "rvdd.train.forward"} <= set(names)


def test_span_tree_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_paths()
    spans = _spans(prof.events())
    count = {}
    for s in spans:
        count[s[0]] = count.get(s[0], 0) + 1
    # prepare twice (inference, train), a step each for inference and the
    # fused path and one an unrolling, the optimizer's zero_grad and step
    assert count == {"rvdd.prepare_frames": 2, "rvdd.demosaic": 2, "rvdd.flow_upsample": 2,
                     "rvdd.step": 4, "rvdd.warp": 4, "rvdd.net": 3, "rvdd.chains": 1,
                     "rvdd.train.forward": 1, "rvdd.train.backward": 1,
                     "rvdd.train.optimizer": 2}
    for child in ("rvdd.demosaic", "rvdd.flow_upsample"):
        assert all("rvdd.prepare_frames" in p for p in _parents(spans, child))
    for child in ("rvdd.warp", "rvdd.net", "rvdd.chains"):
        assert all("rvdd.step" in p for p in _parents(spans, child))
    train = _parents(spans, "rvdd.step")[-2:] + _parents(spans, "rvdd.prepare_frames")[-1:]
    assert all("rvdd.train.forward" in p for p in train)
    for top in ("rvdd.train.forward", "rvdd.train.backward", "rvdd.train.optimizer"):
        assert _parents(spans, top) == [set()] * count[top]
    order = [s[0] for s in sorted(spans, key=lambda s: s[2]) if s[0].startswith("rvdd.train.")]
    assert order == ["rvdd.train.optimizer", "rvdd.train.forward", "rvdd.train.backward",
                     "rvdd.train.optimizer"]


def test_space_spans_in_the_backward_and_byte_counters(tmp_path):
    """Two gloo processes on ``data1xspace2``: a halo of 2 rows above and 3
    below on x [rows, 5, 3] fp32 gathers every shard's first and last 3
    rows (the deeper reach) forward, and hands back the gradient of both
    shards' strips; all_sum hands its 7 floats forward and back; a train
    step opens ``rvdd.space.window`` and ``rvdd.space.gather`` inside
    ``rvdd.train.backward`` and ``rvdd.train.reduce`` after it."""
    from test_torch_dist import WORKER, torchrun

    inp = tmp_path / "in.npz"
    np.savez(inp, kind="trace", mesh="data1xspace2", x_shape=np.array([16, 5, 3]), lo=2, hi=3,
             arch="convunet-mode=fixedfeatures+feat-filters=8", patch_depth=3,
             raw_height=16, raw_width=16)
    torchrun(2, WORKER, "jobs", str(inp), str(tmp_path))
    strip = 3 * 5 * 3 * 4  # k = 3 rows of 5 x 3 fp32
    for r in range(2):
        got = json.load(open(os.path.join(tmp_path, f"rank{r}.json")))
        assert got["halo_forward"] == 2 * strip  # the first and the last k rows
        assert got["halo_backward"] == 2 * 2 * strip  # both shards' strips
        assert got["all_sum"] == 2 * 7 * 4
        spans = [tuple(s) for s in got["spans"]]
        (backward,) = [s for s in spans if s[0] == "rvdd.train.backward"]
        for name in ("rvdd.space.window", "rvdd.space.gather"):
            mine = [s for s in spans if s[0] == name]
            assert any(_inside(s, backward) for s in mine), name
            assert any(not _inside(s, backward) for s in mine), name
        (reduce,) = [s for s in spans if s[0] == "rvdd.train.reduce"]
        assert reduce[2] >= backward[3]


def _event(name, device, start, end, eid=0, thread=1, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, id=eid, thread=thread,
                                 is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_bench_device_events_find_the_solver_by_rvdd_flows():
    """Kernels whose launch call starts inside ``rvdd.flows`` are the
    solver's, whichever thread launched them and wherever they ran on the
    device; the device copies of annotations are no kernels."""
    events = [
        _event("rvdd.flows", CPU, 10, 50, eid=900),
        _event("cudaLaunchKernel", CPU, 12, 13, eid=1),
        _event("warp_bicubic_kernel_narrow", CUDA, 60, 61, eid=1),  # ran after the span
        _event("cuLaunchKernelEx", CPU, 40, 41, eid=2, thread=2),
        _event("at::native::elementwise", CUDA, 45, 46, eid=2),
        _event("cudaLaunchKernel", CPU, 55, 56, eid=3),
        _event("warp_bicubic_kernel_wide", CUDA, 57, 58, eid=3),
        _event("nccl:all_gather", CUDA, 40, 46, eid=7, annotation=True),
        _event("conv_layer_kernel", CUDA, 70, 71, eid=4),  # no launch call in the trace
    ]
    kernels, in_solver = bench._device_events(events)
    assert [k.name for k in kernels] == ["warp_bicubic_kernel_narrow", "at::native::elementwise",
                                         "warp_bicubic_kernel_wide", "conv_layer_kernel"]
    assert in_solver == [True, True, False, False]
    assert [bench._kernel_group(k.name, s) for k, s in zip(kernels, in_solver)] == [
        "tvl1 solver: warp_catmull_zero (CUDA)", "tvl1 solver: plain torch",
        "warp_bicubic (CUDA)", "conv_chain (CUDA)"]
