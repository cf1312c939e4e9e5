"""The port's dataset generator (rvdd_tpu_torch/cli/generate_data.py)
against rvdd_tpu's: both write the same tree from the same sRGB clip, and
the port's files are rvdd_tpu's pipeline applied to the port's own draws
(replayed from its generator), to 1e-4."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from rvdd_tpu.cli.generate_data import main as jgenerate  # noqa: E402
from rvdd_tpu.data import io as jio  # noqa: E402
from rvdd_tpu.ops import pipeline as jpipe  # noqa: E402
from rvdd_tpu_torch.cli.generate_data import main as generate  # noqa: E402
from rvdd_tpu_torch.data.io import imread  # noqa: E402
from test_torch_validate import srgb_clip  # noqa: E402

FRAMES, ISO = 3, 3200


def tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen"))
    srgb_clip(root, FRAMES, 48, 64)
    src = os.path.join(root, "srgb", "%03d", "%08d.png")
    common = ["--input_train_dataset", src, "--input_val_dataset", src, "--nb_seq_train", "1",
              "--nb_seq_val", "1", "--first", "0", "--last", str(FRAMES - 1), "--step", "1",
              "--ISO", str(ISO), "--seed", "5"]
    outs = {}
    for name, main, extra in (("jax", jgenerate, []), ("port", generate, ["--device", "cpu"])):
        d = os.path.join(root, name)
        main(common + ["--output_train_dataset", os.path.join(d, "train"),
                       "--output_val_dataset", os.path.join(d, "validation")] + extra)
        outs[name] = tree(d)
    return src, outs


def test_same_tree(trees):
    _, outs = trees
    assert sorted(outs["port"]) == sorted(outs["jax"])
    assert len(outs["port"]) == 2 * 3 * FRAMES + FRAMES  # + gt_RGB for validation
    for rel, p in outs["port"].items():
        a, b = imread(p), jio.imread(outs["jax"][rel])
        b = b if b.ndim == 3 else b[..., None]
        assert a.shape == b.shape and a.dtype == b.dtype, rel


@pytest.mark.parametrize("split,seed", [("train", 5), ("validation", 6)])
def test_files_are_the_pipeline_of_the_draws(trees, split, seed):
    """Replaying the split's generator (--seed, +1 for validation): the
    dither, then the noise, frame by frame.  rvdd_tpu's unprocess of the
    dithered frame gives the port's gt_iso and gt_raw_linear_RGB files, and
    the noise model with the replayed normals its noisy file (1e-4
    relative; the rounded uint16 and uint8 files within one level)."""
    src, outs = trees
    files = outs["port"]
    gen = torch.Generator().manual_seed(seed)
    gains = jpipe.find_gains(0, ISO)
    a, b = jpipe.NOISE_PARAMS[ISO]
    for t in range(FRAMES):
        img = jio.imread(src % (0, t)).astype(np.float32)
        dither = (torch.rand(img.shape, generator=gen) - 0.5).numpy()
        lin, raw = jpipe.unprocess(jnp.asarray(img + dither), gains, key=None)
        gt_raw = np.asarray(jpipe.to_stored_range(raw, ISO))
        gt_lin = np.asarray(jpipe.to_stored_range(lin, ISO))
        z = torch.randn(gt_raw.shape, generator=gen).numpy()
        name = f"{t:08d}"

        def read(folder, ext="tiff"):
            return imread(files[os.path.join(split, f"{folder}_iso{ISO}", "000", f"{name}.{ext}")])

        np.testing.assert_allclose(read("gt"), gt_raw, rtol=1e-4)
        np.testing.assert_allclose(read("noisy"), gt_raw + np.sqrt(np.clip(a * gt_raw + b, 0, None)) * z,
                                   rtol=1e-4)
        want_lin = np.round(gt_lin).clip(0, 4095)
        assert np.abs(read("gt_raw_linear_RGB").astype(np.float64) - want_lin).max() <= 1
        if split == "validation":
            srgb = np.asarray(jpipe.forward_pipeline(jnp.asarray(gt_lin), gains, ISO))
            got = read("gt_RGB", "png").astype(np.int64)
            assert np.abs(got - srgb.round().clip(0, 255)).max() <= 1
