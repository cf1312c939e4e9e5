"""Checkpoint loading, the load side of rvdd_tpu/training/checkpoints.py.

* rvdd_tpu's ``<epoch>_net_Denoise.msgpack`` files: flax's msgpack
  serialization of the params (maps of strings to maps, and ndarray leaves
  as msgpack ext type 1 holding ``(shape, dtype name, buffer)``), read by a
  small msgpack decoder of the port's own, then converted with
  models/convert.py (HWIO -> OIHW);
* the reference's released ``.pth`` state dicts (a ``.pth`` path, or a
  reference-style prefix ``<path2epoch>_net_Denoise.pth``), through
  models/convert.py:load_torch_checkpoint.

Saving checkpoints belongs to the training slice (ROADMAP.md).
"""

from __future__ import annotations

import struct
from os.path import isfile, join
from typing import Any, Dict, Optional

import numpy as np
import torch

from rvdd_tpu_torch.models.convert import (
    check_state_dict,
    convnext_from_flax,
    convunet_from_flax,
    load_torch_checkpoint,
)
from rvdd_tpu_torch.models.convnext_unet import ConvNeXtUNet

# flax.serialization's ext type codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A msgpack decoder for what flax writes: nil, booleans, integers,
    floats, strings, binaries, arrays, maps and ext types."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.d):
            raise ValueError("msgpack: truncated data")
        out = self.d[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack("BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack("BHI"[b - 0xC7])
            return self.ext(self.unpack("b"), self.take(n))
        if b == 0xCA:
            return self.unpack("f")
        if b == 0xCB:
            return self.unpack("d")
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.take(self.unpack("BHI"[b - 0xD9])).decode("utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.unpack("HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack("HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def ext(code: int, payload: bytes):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, buf = _Reader(payload).whole()
            name = name.decode() if isinstance(name, bytes) else name
            if name == "bfloat16":
                raise ValueError("msgpack: bfloat16 leaves are not supported")
            arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re_, im = _Reader(payload).whole()
            return complex(re_, im)
        raise ValueError(f"msgpack: unknown ext type {code}")

    def whole(self) -> Any:
        v = self.value()
        if self.pos != len(self.d):
            raise ValueError("msgpack: trailing bytes")
        return v


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore without msgpack or flax: the
    python tree with numpy array leaves (read-only views of ``data``)."""
    tree = _Reader(data).whole()

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("msgpack: chunked arrays (leaves over 1 GiB) are not supported")
            for v in node.values():
                check(v)

    check(tree)
    return tree


def _net_file(save_dir: str, epoch: str, name: str = "Denoise") -> str:
    return join(save_dir, f"{epoch}_net_{name}.msgpack")


def state_dict_from_flax(params, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """rvdd_tpu's flax params -> ``net``'s state_dict, checked."""
    conv = convnext_from_flax if isinstance(net, ConvNeXtUNet) else convunet_from_flax
    sd = conv(params)
    check_state_dict(sd, net)
    return sd


def load_checkpoint(path_or_dir: str, epoch: Optional[str], net: torch.nn.Module) -> None:
    """Load weights into ``net`` (in place, on its device).

    Accepts:
    * (save_dir, epoch) pairs -> ``<epoch>_net_Denoise.msgpack`` written by
      rvdd_tpu's save_checkpoint, or ``<epoch>_net_Denoise.pth``;
    * ``epoch=None``: a ``*.pth`` file or a reference-style prefix
      (``<prefix>_net_Denoise.pth``), else a msgpack file's path.
    """
    if epoch is None:
        pth = [path_or_dir, f"{path_or_dir}_net_Denoise.pth"]
    else:
        pth = [join(path_or_dir, f"{epoch}_net_Denoise.pth")]
    for c in pth:
        if c.endswith(".pth") and isfile(c):
            sd = load_torch_checkpoint(c, net)
            break
    else:
        f = _net_file(path_or_dir, epoch) if epoch is not None else path_or_dir
        with open(f, "rb") as fh:
            sd = state_dict_from_flax(msgpack_restore(fh.read()), net)
    net.load_state_dict(sd)
