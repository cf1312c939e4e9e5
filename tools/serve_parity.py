"""The fused path's PSNR cost in validate, rvdd_tpu against its H100 port,
on the CPU: both packages' validate CLIs on one synthetic clip with the
trained convunet+feat net, each package's fused path ('fast'; rvdd_tpu's
Pallas kernels in interpret mode, the port's kernels' plain versions)
against its own exact path (rvdd_tpu's XLA path, the port's fp32 module
path), per frame and (the port only, and rvdd_tpu where the clip is small)
with --val_scan.

    python tools/serve_parity.py --height 256 --width 384 --frames 7 \\
        --textures smooth,rich [--root DIR [--reuse]]

The clips, flows and outputs go to a new temporary directory, removed at
the end, unless --root names one; the clips are made anew on every run unless --reuse is given and
DIR already holds them.  Prints each run's PSNR_valLoss and one ``DELTA <texture> <package>
<protocol> <fused - exact dB>`` line each.  The clips are
tools/make_tiny_dataset.py:synth_video's, made into raw by rvdd_tpu's
generate_data at ISO 3200.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.experimental.pallas as pl_mod  # noqa: E402

from make_tiny_dataset import synth_video  # noqa: E402
from rvdd_tpu.cli import validate as jvalidate  # noqa: E402
from rvdd_tpu.cli.generate_data import main as jgenerate  # noqa: E402
from rvdd_tpu.data.io import imwrite  # noqa: E402
from rvdd_tpu_torch.cli import validate  # noqa: E402

TRAINED = os.path.join(ROOT, "trained-nets", "recurrent-convunet+feat-tinyconv-iso3200.msgpack")
RUNS = (("module", []), ("fused", ["--net_impl", "fused"]), ("module_scan", ["--val_scan"]),
        ("fused_scan", ["--net_impl", "fused", "--val_scan"]))


def run_jax(argv):
    orig = pl_mod.pallas_call
    pl_mod.pallas_call = lambda *a, **k: orig(*a, **dict(k, interpret=True))
    try:
        jvalidate.main(argv)
    finally:
        pl_mod.pallas_call = orig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--frames", type=int, default=7)
    ap.add_argument("--textures", default="smooth,rich")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a new temporary directory)")
    ap.add_argument("--reuse", action="store_true",
                    help="keep the clips already under --root instead of making them anew")
    ap.add_argument("--jax_scan_max_pixels", type=int, default=60000,
                    help="run rvdd_tpu's fused --val_scan only up to this many sRGB pixels "
                         "(its interpret-mode scan is slow)")
    a = ap.parse_args(argv)
    base = a.root or tempfile.mkdtemp(prefix="serve_parity_")
    try:
        out = run_all(a, base)
    finally:
        if a.root is None:
            shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out))


def run_all(a, base):
    out = {}
    for tex in a.textures.split(","):
        root = os.path.join(base, f"{tex}_{a.height}x{a.width}")
        if not (a.reuse and os.path.isdir(os.path.join(root, "validation"))):
            shutil.rmtree(root, ignore_errors=True)
            for t, img in enumerate(synth_video(0, a.frames, a.height, a.width, tex)):
                imwrite(os.path.join(root, "srgb", "000", f"{t:08d}.png"), img)
            jgenerate(["--input_val_dataset", os.path.join(root, "srgb", "%03d", "%08d.png"),
                       "--output_val_dataset", os.path.join(root, "validation"),
                       "--nb_seq_val", "1", "--first", "0", "--last", str(a.frames - 1),
                       "--step", "1"])
        common = ["--netDenoiser", "convunet-mode=fixedfeatures+feat", "--feature_rec",
                  "--path2epoch", TRAINED, "--val_dataroot", os.path.join(root, "validation"),
                  "--gtFolder", "gt_iso3200", "--nFolder", "noisy_iso3200",
                  "--gt_linear_RGB_Folder", "gt_raw_linear_RGB_iso3200", "--val_videos", "000",
                  "--compilation_cache_dir", "", "--name", "r"]
        res = {}
        for pkg in ("jax", "port"):
            for tag, extra in RUNS:
                if (pkg == "jax" and tag == "fused_scan"
                        and a.height * a.width > a.jax_scan_max_pixels):
                    continue
                ck = os.path.join(root, f"ck_{pkg}_{tag}")
                if pkg == "jax":
                    run_jax(common + ["--checkpoints_dir", ck] + extra)
                else:
                    validate.main(common + ["--checkpoints_dir", ck, "--device", "cpu"] + extra)
                with open(os.path.join(ck, "r", "val_losses.json")) as f:
                    res[f"{pkg}_{tag}"] = json.load(f)["PSNR_valLoss"]
                print(tex, pkg, tag, res[f"{pkg}_{tag}"], flush=True)
        for pkg in ("jax", "port"):
            for proto in ("", "_scan"):
                if f"{pkg}_fused{proto}" in res:
                    print("DELTA", tex, pkg, (proto or "_per_frame")[1:],
                          res[f"{pkg}_fused{proto}"] - res[f"{pkg}_module{proto}"], flush=True)
        out[tex] = res
    return out


if __name__ == "__main__":
    main()
