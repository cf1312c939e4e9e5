"""The port stands alone: no module of rvdd_tpu_torch, and not chip_smoke.py,
imports jax, flax or rvdd_tpu, nor imageio, PIL or msgpack (the card's
machine has none of them); and its entry points refuse to run without a
card unless the caller asks for the CPU."""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rvdd_tpu", "imageio", "PIL", "msgpack")


def _sources():
    files = sorted((ROOT / "rvdd_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_rvdd_tpu_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), f"{path.name} imports {sorted(roots & set(FORBIDDEN))}"


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    from rvdd_tpu_torch import bench, resolve_device
    from rvdd_tpu_torch.models import build_network

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_network("convunet-mode=fixedfeatures+feat", 6, 3)
    with pytest.raises(RuntimeError):
        build_network("newunet-mode=feat", 9, 3)
    with pytest.raises(RuntimeError):
        bench.run(frames=1)
    with pytest.raises(RuntimeError):
        bench.run(frames=1, device="cpu")  # the benchmark only measures the card
    with pytest.raises(RuntimeError):
        bench.run(frames=1, model="convnext+feat+future")
    with pytest.raises(RuntimeError):
        bench.run(frames=1, model="convunet+feat+future")
    assert resolve_device("cpu") == torch.device("cpu")
    for arch, in_nc in (("convunet-mode=fixedfeatures+feat", 6), ("newunet-mode=feat", 9)):
        net = build_network(arch, in_nc, 3, device="cpu")
        assert next(net.parameters()).device.type == "cpu"


def test_online_flow_entry_points_need_a_card(monkeypatch):
    """bench's online-flow mode measures the card only; the solver itself
    runs wherever its tensors are (its CPU run is the plain version)."""
    from rvdd_tpu_torch import bench
    from rvdd_tpu_torch.ops import tvl1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flow in ("default", "fast"):
        with pytest.raises(RuntimeError):
            bench.run(frames=1, flow=flow)
    with pytest.raises(RuntimeError):
        bench.profile(frames=1, model="convnext+feat+future", flow="fast")
    x = torch.zeros(20, 24)
    assert tvl1.tvl1_flow(x, x, "fast").device.type == "cpu"


def test_kernel_sources_ship_with_the_package():
    from rvdd_tpu_torch import _build

    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
    assert "rvdd_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_bench_convunet_feat_future_path_on_cpu():
    """bench's convunet+feat+future path at a small size on the CPU (the
    wrappers run their plain versions): 'auto' resolves to
    hybrid:glue+A+dec2, chains A and dec2 are packed in the fp32 mode, and
    two streamed frames from raw come out finite.  The metric names follow
    bench.py's (a preset other than 'auto' is appended)."""
    from rvdd_tpu_torch import bench

    model = "convunet+feat+future"
    assert bench.resolve_precision(model) == "hybrid:glue+A+dec2"
    assert bench.resolve_precision("convunet+feat") == "fast"
    assert bench.metric_name(540, 960, model) == "1080p_fps_per_chip_convunet_feat_future"
    assert bench.metric_name(540, 960, model, precision="mixed") == \
        "1080p_fps_per_chip_convunet_feat_future_mixed"
    cfg, net, packed = bench.make_model("fused", seed=0, device="cpu", model=model)
    assert cfg.fused_precision == "hybrid:glue+A+dec2" and cfg.network_input_nc == 9
    assert packed["A"].band_fp32 and packed["dec2"].band_fp32 and not packed["B"].band_fp32
    raw, flows = bench.make_inputs(16, 24, seed=0, device="cpu", model=model)
    den, state = bench.step_fn(cfg, net, packed, None, raw, flows)
    den2, _ = bench.step_fn(cfg, net, packed, state, raw, flows)
    assert den2.shape == (1, 32, 48, 3) and bool(torch.isfinite(den2).all())
    assert state.lastden.dtype == torch.float32 and state.lastden.shape[-1] == 56
