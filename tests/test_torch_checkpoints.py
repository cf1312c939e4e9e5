"""The port's checkpoint loading (rvdd_tpu_torch/training/checkpoints.py and
models/convert.py) against rvdd_tpu's: the msgpack decoder against
flax.serialization, rvdd_tpu's saved checkpoints, and the reference's
``.pth`` state dicts through both packages' converters."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from flax import serialization  # noqa: E402

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.models.convert import load_torch_checkpoint as jload_pth  # noqa: E402
from rvdd_tpu.training.checkpoints import save_checkpoint  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import (  # noqa: E402
    convnext_from_flax,
    convunet_from_flax,
    load_torch_checkpoint,
)
from rvdd_tpu_torch.training.checkpoints import load_checkpoint, msgpack_restore  # noqa: E402

TRAINED = "trained-nets/recurrent-convunet+feat-tinyconv-iso3200.msgpack"


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b))


def test_msgpack_decoder_matches_flax_on_the_trained_net():
    data = open(TRAINED, "rb").read()
    _same_tree(serialization.msgpack_restore(data), msgpack_restore(data))


def test_msgpack_decoder_types():
    """Every msgpack type flax writes: maps, strings, integers of each
    width, floats, nil, booleans, binaries, arrays, ndarrays of several
    dtypes and numpy scalars."""
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"i8": np.int8(-3), "u16": np.arange(5, dtype=np.uint16), "s": "x" * 40,
                  "none": None, "t": True, "f": False, "neg": -7, "n200": -200,
                  "u8": 200, "u16i": 60000, "u32": 1 << 31, "u64": 1 << 40, "i32": -(1 << 20),
                  "f64": 2.5, "bin": b"\x00\x01" * 200, "list": [1, 2, "three"],
                  "big": np.zeros((70, 70), np.float64)},
            "long" * 20: {str(i): i for i in range(20)}}
    data = serialization.msgpack_serialize(tree)
    got = msgpack_restore(data)
    _same_tree(serialization.msgpack_restore(data), got)
    assert got["b"]["u16"].dtype == np.uint16 and got["b"]["i8"] == -3


def test_load_checkpoint_of_rvdd_tpu(tmp_path):
    """rvdd_tpu's save_checkpoint file, loaded by epoch and by path: the
    port's net gives rvdd_tpu's net's output to 1e-4 normalized."""
    params = serialization.msgpack_restore(open(TRAINED, "rb").read())
    save_checkpoint(str(tmp_path), "latest_val", params)
    jnet = jfactory.build_network("convunet-mode=fixedfeatures+feat", 6, 3, True)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 32, 48, 6)).astype(np.float32)
    feat = rng.uniform(-1, 1, (1, 32, 48, 48)).astype(np.float32)
    want, _ = jnet.apply({"params": params}, jax.numpy.asarray(x), jax.numpy.asarray(feat))
    for where in ((str(tmp_path), "latest_val"),
                  (str(tmp_path / "latest_val_net_Denoise.msgpack"), None)):
        net = build_network("convunet-mode=fixedfeatures+feat", 6, 3, True, seed=1, device="cpu")
        load_checkpoint(*where, net)
        with torch.no_grad():
            got, _ = net(torch.from_numpy(x), torch.from_numpy(feat))
        err = np.abs(got.numpy() - np.asarray(want)).max() / np.std(np.asarray(want))
        assert err < 1e-4, err


def test_pth_convunet_matches_rvdd_tpu(tmp_path):
    """The reference state dict of tests/golden/grads_convunet_feat.npz
    (sd/), saved as a .pth: the port's converter gives the flax params
    rvdd_tpu's converter gives, in the port's layout, exactly; and the
    reference-style prefix <p>_net_Denoise.pth loads the same."""
    g = np.load("tests/golden/grads_convunet_feat.npz")
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd/")}
    p = tmp_path / "ref_net_Denoise.pth"
    torch.save(sd, str(p))
    arch = "convunet-mode=fixedfeatures+feat-filters=12"
    jnet = jfactory.build_network(arch, 6, 3, True)
    want = convunet_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jload_pth(str(p), jnet, (1, 32, 32, 6))))
    net = build_network(arch, 6, 3, True, device="cpu")
    got = load_torch_checkpoint(str(p), net)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    net2 = build_network(arch, 6, 3, True, seed=3, device="cpu")
    load_checkpoint(str(tmp_path / "ref"), None, net2)
    for k, v in net2.state_dict().items():
        assert torch.equal(v, want[k]), k


#: the reference's ConvNeXt module names by flax path prefix (the inverse of
#: rvdd_tpu/models/convert.py:convert_convnext)
_CNX_BLOCK = {"proj": "proj", "dw": "block.0", "ln": "block.1", "pw1": "block.2",
              "pw2": "block.4", "layerscale": "layerscale"}


def _reference_name(path):
    top, rest = path[0], list(path[1:])
    m = re.match(r"(enc_conv|dec_conv|enc_down|dec_up|fuse_scale)(\d+)$", top)
    if top == "post_final":
        return "postprocessing.1." + ("weight" if rest[0] == "kernel" else "bias")
    if m and m[1] == "fuse_scale":
        return f"layerscales.{m[2]}.layerscale"
    if m and m[1] in ("enc_down", "dec_up"):
        pre = {"enc_down": "encoder_downs", "dec_up": "decoder_ups"}[m[1]] + f".{m[2]}.postconv"
    else:
        blk = rest.pop(0)[len("block"):]
        pre = {"pre": "preprocessing_layer", "bottleneck": "bottleneck",
               "post": "postprocessing.0"}.get(top)
        if pre is None:
            pre = {"enc_conv": "encoder_convs", "dec_conv": "decoder_convs"}[m[1]] + f".{m[2]}"
        pre += f".blocks.{blk}"
    sub, leaf = rest
    if sub == "layerscale":
        return f"{pre}.layerscale.layerscale"
    return f"{pre}.{_CNX_BLOCK[sub]}.{'weight' if leaf in ('kernel', 'weight') else 'bias'}"


def test_pth_convnext_matches_rvdd_tpu(tmp_path):
    """A ConvNeXtUNet+feat state dict in the reference's module names (made
    from random flax params: tests/golden/net_convnext_feat_future.npz holds
    the net's inputs and outputs, not its state dict), saved as a .pth:
    rvdd_tpu's load_torch_checkpoint accepts it (its tree equals the net's)
    and the port's converter gives the same weights in the port's layout."""
    jnet = jfactory.build_network("newunet-mode=feat", 9, 3, True)
    params = jax.tree_util.tree_map(
        np.asarray, jfactory.init_network(jnet, jax.random.PRNGKey(2), (1, 64, 64, 9)))
    sd = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        path = [str(k.key) for k in kp]
        a = np.asarray(leaf, np.float32)
        sd[_reference_name(path)] = torch.from_numpy(
            a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a.copy())
    p = tmp_path / "cnx.pth"
    torch.save(sd, str(p))
    want = convnext_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jload_pth(str(p), jnet, (1, 64, 64, 9))))
    net = build_network("newunet-mode=feat", 9, 3, True, device="cpu")
    got = load_torch_checkpoint(str(p), net)
    assert got.keys() == want.keys() == net.state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
