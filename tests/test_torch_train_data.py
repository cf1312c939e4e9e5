"""The port's TrainWindowDataset (rvdd_tpu_torch/data/datasets.py) against
rvdd_tpu's on one tiny on-disk set: two sequences of 7 frames (packed raw
12x20, linear RGB or raw ground truth), read in windows of 5 frames with a
future frame.  From the same seed both draw the same windows, keys and
order, and give the same batches bit for bit over two epochs; with flows
persisted on disk (written here, in the reference's layout, for every
neighbouring pair) both caches read the same flows.  rvdd_tpu reads with
imageio here, as it does where its native decode pool is not built: the
pool scales by a float32 reciprocal of 4095 and rounds some values one ulp
away from the division that rvdd_tpu's imageio path and the port compute.
An abandoned ``batches`` generator stops its thread."""

import gc
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from rvdd_tpu.data import io as jio  # noqa: E402
from rvdd_tpu.data.datasets import TrainWindowDataset as JTrainWindowDataset  # noqa: E402
from rvdd_tpu.data.flow_cache import FlowCache as JFlowCache  # noqa: E402
from rvdd_tpu_torch.data.datasets import TrainWindowDataset  # noqa: E402
from rvdd_tpu_torch.data.flow_cache import FlowCache, flow_filename  # noqa: E402

SEQS, FRAMES, H, W = 2, 7, 12, 20


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    rng = np.random.default_rng(0)
    for s in range(SEQS):
        seq = f"{s:03d}"
        for t in range(FRAMES):
            name = f"{t:08d}.tiff"
            jio.imwrite(os.path.join(root, "noisy", seq, name),
                        rng.uniform(0, 4095, (H, W, 4)).astype(np.float32))
            jio.imwrite(os.path.join(root, "gt", seq, name),
                        rng.uniform(0, 4095, (H, W, 4)).astype(np.float32))
            jio.imwrite(os.path.join(root, "gt_linear_RGB", seq, name),
                        rng.integers(0, 4096, (2 * H, 2 * W, 3)).astype(np.uint16))
        fdir = os.path.join(root, "flow", "noisy", "tvl1", "noisyinputs", seq)
        for t in range(FRAMES - 1):
            for a, b in ((t, t + 1), (t + 1, t)):
                jio.imwrite(flow_filename(fdir, f"{a:08d}", f"{b:08d}"),
                            rng.normal(0, 2, (H, W, 2)).astype(np.float32))
    return root


@pytest.fixture(autouse=True)
def _imageio_reads(monkeypatch):
    monkeypatch.setattr(jio, "_native", False)


def _datasets(root, raw_gt, flows):
    kw = dict(patch_width=8, patch_stride=3, patch_depth=3, model_patch_depth=2,
              future_patch_depth=1, frames2load=5, raw_gt=raw_gt, seed=7)
    gt = "gt" if raw_gt else "gt_linear_RGB"
    jcache = JFlowCache(root, "noisy") if flows else None
    cache = FlowCache(root, "noisy", device="cpu") if flows else None
    return (JTrainWindowDataset(root, gt, "noisy", flow_cache=jcache, **kw),
            TrainWindowDataset(root, gt, "noisy", flow_cache=cache, **kw), cache)


@pytest.mark.parametrize("flows", [False, True], ids=["no_flows", "persisted_flows"])
@pytest.mark.parametrize("raw_gt", [False, True], ids=["rgb_gt", "raw_gt"])
def test_same_windows_keys_order_and_batches(root, raw_gt, flows):
    want, got, cache = _datasets(root, raw_gt, flows)
    for epoch in range(2):
        assert np.array_equal(got.keys, want.keys) and got.indices == want.indices
        assert len(got) == len(want) > 0
        bw = list(want.batches(2))
        bg = list(got.batches(2))
        assert len(bg) == len(bw) == len(want) // 2
        for a, b in zip(bg, bw):
            assert a.keys() == b.keys() == {"gt", "n", "n_path"} | ({"flow"} if flows else set())
            assert a["n_path"] == b["n_path"]
            for k in a.keys() - {"n_path"}:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (epoch, k)
        up = 1 if raw_gt else 2
        assert bg[0]["gt"].shape == (2, 3, 8 * up, 8 * up, 4 if raw_gt else 3)
        assert bg[0]["n"].shape == (2, 4, 8, 8, 4)
        if flows:
            assert bg[0]["flow"].shape == (2, 2, 2, 8, 8, 2)
        want.prepare_epoch()
        got.prepare_epoch()
    if flows:
        assert cache.computed == 0  # every flow was read from disk


def test_crops_keep_the_bayer_phase(root):
    """Every crop starts on an even raw row and column, and its ground
    truth is the RGB window at twice the raw coordinates."""
    _, ds, _ = _datasets(root, False, False)
    full = ds.videos_gt
    for idx in range(len(ds)):
        i, x, y, z = (int(v) for v in ds.keys[ds.indices[idx]])
        x0, y0 = x - 8 - (x - 8) % 2, y - 8 - (y - 8) % 2
        assert x0 % 2 == 0 and y0 % 2 == 0
        item = ds[idx]
        np.testing.assert_array_equal(item["gt"], 2 * full[i][z:z + 3, 2 * y0:2 * y0 + 16,
                                                              2 * x0:2 * x0 + 16] - 1)


def _producers():
    return [t for t in threading.enumerate() if t.name.endswith("(producer)")]


def test_abandoned_batches_generator_stops_its_thread(root):
    _, ds, _ = _datasets(root, False, False)
    before = len(_producers())
    gen = ds.batches(1, prefetch=1)
    next(gen)
    assert len(_producers()) == before + 1
    gen.close()
    assert len(_producers()) == before
    gen = ds.batches(1, prefetch=1)
    next(gen)
    del gen
    gc.collect()
    assert len(_producers()) == before
