"""The port's serving entry points (rvdd_tpu_torch/cli/{validate,score,flow}.py)
against rvdd_tpu's on one tiny on-disk dataset: a 4-frame clip made by
rvdd_tpu's generate_data from a smooth moving sRGB texture (raw 32x48),
the trained convunet+feat net saved by rvdd_tpu's save_checkpoint, and a
flow cache that rvdd_tpu writes first and the port then reads.  Both
validate CLIs run one argv (the port's with ``--device cpu`` added);
rvdd_tpu's runs with ``--compilation_cache_dir ''`` and
``--exact_precision``, its fused path in Pallas interpret mode."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from flax import serialization  # noqa: E402

from rvdd_tpu.cli import score as jscore  # noqa: E402
from rvdd_tpu.cli import validate as jvalidate  # noqa: E402
from rvdd_tpu.cli.generate_data import main as jgenerate  # noqa: E402
from rvdd_tpu.data import io as jio  # noqa: E402
from rvdd_tpu.training.checkpoints import save_checkpoint  # noqa: E402
from rvdd_tpu_torch.cli import flow as flow_cli  # noqa: E402
from rvdd_tpu_torch.cli import score, validate  # noqa: E402
from rvdd_tpu_torch.data.flow_cache import FlowCache  # noqa: E402
from rvdd_tpu_torch.data.io import imread, list_video_files  # noqa: E402

TRAINED = "trained-nets/recurrent-convunet+feat-tinyconv-iso3200.msgpack"
FRAMES, H, W = 4, 64, 96  # sRGB size; raw is 32x48


def srgb_clip(root, frames=FRAMES, h=H, w=W):
    """A smooth texture under a window moving 2 px right and 1 px down a
    frame (as tools/make_tiny_dataset.py:synth_video), 8-bit PNG."""
    yy, xx = np.mgrid[0:h + 2 * frames, 0:w + 2 * frames].astype(np.float32)
    base = 110 + 70 * np.sin(xx / 6) * np.cos(yy / 8) + 40 * np.sin((xx + yy) / 17)
    for t in range(frames):
        win = base[t:t + h, 2 * t:2 * t + w]
        rgb = np.stack([win, 0.85 * win + 15, 0.7 * win + 8], -1)
        jio.imwrite(os.path.join(root, "srgb", "000", f"{t:08d}.png"),
                    np.clip(rgb, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve"))
    srgb_clip(root)
    jgenerate(["--input_val_dataset", os.path.join(root, "srgb", "%03d", "%08d.png"),
               "--output_val_dataset", os.path.join(root, "validation"), "--nb_seq_val", "1",
               "--first", "0", "--last", str(FRAMES - 1), "--step", "1"])
    params = serialization.msgpack_restore(open(TRAINED, "rb").read())
    save_checkpoint(os.path.join(root, "ckpt"), "latest_val", params)
    return root


def argv(root, out, *extra):
    return ["--netDenoiser", "convunet-mode=fixedfeatures+feat", "--feature_rec",
            "--path2epoch", os.path.join(root, "ckpt", "latest_val_net_Denoise.msgpack"),
            "--val_dataroot", os.path.join(root, "validation"), "--gtFolder", "gt_iso3200",
            "--nFolder", "noisy_iso3200", "--gt_linear_RGB_Folder", "gt_raw_linear_RGB_iso3200",
            "--val_videos", "000", "--checkpoints_dir", os.path.join(root, out),
            "--name", "run", "--compilation_cache_dir", "", "--exact_precision", *extra]


_RUNS = {}


@pytest.fixture(scope="module")
def runs(data):
    """run(*extra) -> (rvdd_tpu's result dir, the port's); each pair runs
    once a module.  rvdd_tpu's first run writes the flow cache."""
    import jax.experimental.pallas as pl_mod

    def run(*extra):
        if extra not in _RUNS:
            tag = "_".join(e.strip("-") for e in extra) or "base"
            orig = pl_mod.pallas_call
            pl_mod.pallas_call = lambda *a, **k: orig(*a, **dict(k, interpret=True))
            try:
                jvalidate.main(argv(data, "jax_" + tag, *extra))
            finally:
                pl_mod.pallas_call = orig
            validate.main(argv(data, "port_" + tag, *extra) + ["--device", "cpu"])
            _RUNS[extra] = tuple(os.path.join(data, f"{p}_{tag}", "run") for p in ("jax", "port"))
        return _RUNS[extra]

    run()  # the flow cache, from rvdd_tpu
    return run


def losses(d):
    with open(os.path.join(d, "val_losses.json")) as f:
        return json.load(f)


def images(d):
    seq = os.path.join(d, "val_visuals", "000")
    names = sorted(os.listdir(seq))
    assert names == [f"{t:08d}_denoised.tif" for t in range(1, FRAMES)]
    return [imread(os.path.join(seq, n)) for n in names]


def norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


@pytest.mark.parametrize("extra", [(), ("--val_scan",), ("--no_warp",),
                                   ("--val_flow_from_denoised",), ("--val_pad_multiple", "20")],
                         ids=["per_frame", "val_scan", "no_warp", "flow_from_denoised",
                              "pad_multiple"])
def test_validate_module_path_matches_rvdd_tpu(runs, extra):
    """The module path (rvdd_tpu's --net_impl xla): val_losses.json within
    0.01 dB of PSNR and 1e-4 relative L1, every _denoised.tif within
    1e-3 x 255.  (--val_flow_from_denoised computes each flow with each
    package's own solver, within tests/test_tvl1.py's route limits of each
    other, so its images get 1e-2 x 255.)"""
    jdir, pdir = runs(*extra)
    want, got = losses(jdir), losses(pdir)
    assert set(got) == set(want) == {"L1_valLoss", "PSNR_valLoss", "Denoiser_valLoss"}
    assert abs(got["PSNR_valLoss"] - want["PSNR_valLoss"]) < 0.01, (got, want)
    assert abs(got["L1_valLoss"] / want["L1_valLoss"] - 1) < 1e-4, (got, want)
    tol = 1e-2 if "--val_flow_from_denoised" in extra else 1e-3
    for a, b in zip(images(pdir), images(jdir)):
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() < tol * 255, np.abs(a - b).max()


def test_validate_fused_path_matches_rvdd_tpu(runs):
    """--net_impl fused per frame ('fast'; rvdd_tpu's Pallas kernels in
    interpret mode): each frame within 'fast''s envelope (normalized max
    error < 0.2 for the first frame, < 0.3 for the carried ones) of both
    rvdd_tpu's fused run and its exact module run, and the PSNRs within
    0.05 dB (PARITY.md's budget).  The fused path's PSNR cost against each
    package's own exact path is rvdd_tpu's within 0.01 dB, a fifth of the
    budget (tools/serve_parity.py measures it on larger clips)."""
    jdir, pdir = runs("--net_impl", "fused")
    exact_dir, port_exact_dir = runs()
    for t, (g, w, e) in enumerate(zip(images(pdir), images(jdir), images(exact_dir))):
        lim = 0.2 if t == 0 else 0.3
        assert norm_err(g, w) < lim and norm_err(g, e) < lim, (t, norm_err(g, w), norm_err(g, e))
    psnr = {k: losses(d)["PSNR_valLoss"] for k, d in
            (("port", pdir), ("jax", jdir), ("port_exact", port_exact_dir), ("jax_exact", exact_dir))}
    assert abs(psnr["port"] - psnr["jax"]) < 0.05, psnr
    cost = psnr["port"] - psnr["port_exact"], psnr["jax"] - psnr["jax_exact"]
    assert abs(cost[0] - cost[1]) < 0.01, (cost, psnr)


@pytest.mark.parametrize("preset", ["default", "fast"])
def test_validate_online_flow(runs, data, preset):
    """--online_flow: each window's flows come from the port's solver inside
    the step instead of the cache (rvdd_tpu's _val_step route); the default
    preset reads what the cached flows read (rvdd_tpu's solver, the same
    parameters) within 0.01 dB of PSNR, the fast one within 0.05 dB."""
    cached = losses(runs()[1])["PSNR_valLoss"]
    validate.main(argv(data, f"port_online_{preset}", "--online_flow", "--flow_preset", preset)
                  + ["--device", "cpu"])
    got = losses(os.path.join(data, f"port_online_{preset}", "run"))["PSNR_valLoss"]
    assert abs(got - cached) < (0.01 if preset == "default" else 0.05), (got, cached)


def test_score_matches_rvdd_tpu(runs, data, tmp_path):
    """score of both packages on one result folder: the same PSNR.txt and
    SSIM.txt to 1e-6, and the same processed PNGs."""
    src, _ = runs()
    out = {}
    for name, main, extra in (("jax", jscore.main, []), ("port", score.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        shutil.copytree(os.path.join(src, "val_visuals"), d)
        main(["--validation_path", os.path.join(data, "validation"), "--result_folder", d,
              "--videos", "0", "--first", "1", "--last", str(FRAMES - 1), "--step", "1"] + extra)
        out[name] = d
    for fname in ("PSNR.txt", "SSIM.txt"):
        vals = []
        for name in ("jax", "port"):
            text = open(os.path.join(out[name], fname)).read()
            nums = [float(x) for x in text.split("###")[0].split()]
            avg = float(text.split("Average:")[1].split()[0])
            vals.append((nums, avg))
        (jn, ja), (pn, pa) = vals
        assert len(pn) == len(jn) == FRAMES - 1
        np.testing.assert_allclose(pn, jn, rtol=0, atol=1e-6)
        assert pa == ja
    for t in range(1, FRAMES):
        f = os.path.join("000", f"{t:08d}_processed_pipeline.png")
        np.testing.assert_array_equal(imread(os.path.join(out["port"], f)),
                                      jio.imread(os.path.join(out["jax"], f)))


def test_port_flow_cache_within_route_limits(runs, data):
    """The port's FlowCache (its TV-L1 solver, on the CPU) computes and
    persists the pairs rvdd_tpu's cache holds, in the same layout, within
    tests/test_tvl1.py's limits of rvdd_tpu's flows (median |d| < 0.02 px,
    mean < 0.05, p95 < 0.12); its files read back bit for bit."""
    val = os.path.join(data, "validation")
    paths = list_video_files(os.path.join(val, "noisy_iso3200", "000"))
    pairs = [(t, t + 1) for t in range(FRAMES - 1)]
    theirs = FlowCache(val, "noisy_iso3200", device="cpu").get_flows("000", paths, pairs)
    mine_cache = FlowCache(val, "noisy_iso3200", flow_folder="flow_port", device="cpu")
    mine = mine_cache.get_flows("000", paths, pairs)
    assert mine_cache.computed == len(pairs) and theirs.shape == mine.shape == (3, 32, 48, 2)
    err = np.abs(mine - theirs)
    assert np.median(err) < 0.02 and err.mean() < 0.05 and np.quantile(err, 0.95) < 0.12
    again = FlowCache(val, "noisy_iso3200", flow_folder="flow_port", device="cpu")
    np.testing.assert_array_equal(again.get_flows("000", paths, pairs), mine)
    assert again.computed == 0
    f = os.path.join(val, "flow_port", "noisy_iso3200", "tvl1", "noisyinputs", "000",
                     "00000000_00000001.tif")
    np.testing.assert_array_equal(jio.imread(f), mine[0])


def test_flow_cli(data, tmp_path):
    """cli/flow.py on two PNG frames: an [H, W, 2] float32 TIFF holding the
    clip's motion in the interior: frame 1 at x is frame 0 at x + (2, 1)."""
    src = os.path.join(data, "srgb", "000")
    out = str(tmp_path / "f.tif")
    flow_cli.main([os.path.join(src, "00000001.png"), os.path.join(src, "00000000.png"), out,
                   "--device", "cpu"])
    f = imread(out)
    assert f.shape == (H, W, 2) and f.dtype == np.float32
    med = np.median(f[8:-8, 8:-8].reshape(-1, 2), axis=0)
    assert np.abs(med - (2.0, 1.0)).max() < 0.25, med


def test_validate_needs_a_card_unless_cpu(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        validate.main(argv(data, "nocard"))
    for main, a in ((score.main, ["--validation_path", "x", "--result_folder", "y"]),
                    (flow_cli.main, ["a.png", "b.png"])):
        with pytest.raises(RuntimeError):
            main(a)
