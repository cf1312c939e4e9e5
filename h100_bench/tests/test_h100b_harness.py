"""The harness itself: BENCHMARK.json against the contract and the files,
the result line's keys, the import rules, and extension by new files."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from h100_bench import harness

from conftest import ROOT, tiny

BENCH = harness.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_has_its_files():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert {k: cell[k] for k in w} == w  # the cell file is the entry, plus its limits
        assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                           harness.load_json("traffic", w["traffic"])
                                           ["generator"] + ".py"))
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_forbidden_names_are_whole_words():
    assert harness.forbidden_modules(["rvdd_tpu_torch", "rvdd_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_modules(["rvdd_tpu.models", "jax.numpy", "flax"]) == \
        ["flax", "jax", "rvdd_tpu"]


@pytest.mark.parametrize("rank,cores,visible,machine,want", [
    (0, range(8), None, 8, (2, 3, 4, 5)),  # one card, the whole machine
    (0, range(32), "3", 32, (14, 15, 16, 17)),  # card 3 of four: its own block
    (0, range(32), "1", 32, (6, 7, 8, 9)),
    (2, range(32), None, 32, (10, 11, 12, 13)),  # rank 2 of a four-card cell
    (1, range(32), "4,5,6,7", 32, (22, 23, 24, 25)),  # rank 1 drives card 5
    (0, range(8), "1", 8, None),  # the block does not fit: left as it started
    (0, range(16, 24), "3", 64, (18, 19, 20, 21)),  # a cpuset of its own
    (1, range(32), "GPU-a,GPU-b", 32, (6, 7, 8, 9)),  # cards by UUID: by rank
])
def test_runs_on_different_cards_take_different_cores(rank, cores, visible, machine, want):
    assert harness.cores_of(rank, tuple(cores), visible, machine) == want


def _python(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = _python(f"""
        import sys, torch
        sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {ROOT + '/h100_bench/tests'!r})
        import h100_bench.run
        from h100_bench import harness
        from conftest import tiny
        for cell in ("convnext_ff.stream", "convunet_ff.train"):
            r = harness.make_run(cell, 5, 0.2, True, "cpu", mix_overrides=tiny(cell))
            harness.generator(r.mix).run(r)
        assert "rvdd_tpu_torch" in sys.modules
        print("BAD", harness.forbidden_modules())
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout


def test_the_reference_imports_nothing_of_the_program():
    out = _python(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import h100_bench.reference.nets, h100_bench.reference.ops
        import h100_bench.reference.recurrent
        print("HELD", sorted(m for m in sys.modules if m.split(".")[0] in
                             ("rvdd_tpu_torch", "rvdd_tpu", "jax")))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "HELD []" in out.stdout


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(trace, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    cell = "convunet_ff.stream"
    r = harness.make_run(cell, 7, 0.2, trace, "cpu", mix_overrides=tiny(cell))
    out = harness.generator(r.mix).run(r)
    line = harness.result(r, out, BENCH)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    if not trace:
        assert set(line["metrics"]) == {"fps", "frame_p95_ms", "setup_s"}
    assert set(line["checks"]) == set(harness.load_json("workloads", cell)["limits"])
    json.dumps(line)


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "convnext_ff.stream", "--seed", "1", "--seconds", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "convnext_ff.stream", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_config_mix_and_metric_are_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric as new files and new BENCHMARK.json entries; the
    harness finds and runs them, and no file it had changes."""
    shutil.copytree(os.path.join(ROOT, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _files(tmp_path / "h100_bench")}
    h = tmp_path / "h100_bench"
    cfg = harness.load_json("configs", "convunet_ff")
    cfg.update(name="convunet_small", preset="fast")
    cfg["net"]["filters"] = 48
    (h / "configs" / "convunet_small.json").write_text(json.dumps(cfg))
    mix = {**harness.load_json("traffic", "stream"), **tiny("stream"), "windows": 2}
    (h / "traffic" / "stream_short.json").write_text(json.dumps(mix))
    cell = {"name": "convunet_small.stream_short", "config": "convunet_small",
            "traffic": "stream_short", "chips": 1, "why": "a test cell",
            "limits": {"max_err": 1.0}}
    (h / "workloads" / "convunet_small.stream_short.json").write_text(json.dumps(cell))
    (h / "metrics" / "frames.stream_short.py").write_text(
        "def read(t):\n    return float(t.units)\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "convunet_small", "source": "https://example.org", "reduced": [],
         "file": "h100_bench/configs/convunet_small.json", "why": "test"}]
    bench["workloads"] = BENCH["workloads"] + [{k: cell[k] for k in cell if k != "limits"}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + [cell["name"]])
                           if m["name"] == "fps" else m for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "frames.stream_short", "unit": "frames", "better": "higher",
         "source": "program_counter", "layer": "test", "moves": "fps",
         "workloads": [cell["name"]]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python(f"""
        import sys, json
        sys.path.insert(0, {str(tmp_path)!r})
        sys.path.append({ROOT!r})  # the program, after the copy's harness
        from h100_bench import harness
        assert harness.HERE.parent.as_posix() == {tmp_path.as_posix()!r}
        r = harness.make_run("convunet_small.stream_short", 3, 0.2, True, "cpu")
        out = harness.generator(r.mix).run(r)
        print("METRICS", json.dumps(harness.per_layer(r, out.trace, harness.benchmark_json())))
    """, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.split("METRICS", 1)[1])
    assert metrics["frames.stream_short"]["value"] >= 8
    assert all(open(p, "rb").read() == b for p, b in before.items())


def _files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d]
