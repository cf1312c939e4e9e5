"""Checkpoint I/O (port of rvdd_tpu/training/checkpoints.py).

File names follow the reference ('<epoch>_net_Denoise', with the epochs
'0', 'latest', 'latest_val' and numbers; reference:
models/base_model.py:155-196, train.py:100-120):

* ``<epoch>_net_Denoise.msgpack``: flax's msgpack serialization of the
  params (maps of strings to maps, ndarray leaves as msgpack ext type 1
  holding ``(shape, dtype name, buffer)``, C order), written and read by a
  small msgpack encoder and decoder of the port's own (the card's machine
  has no msgpack), through models/convert.py (OIHW <-> HWIO).  Either
  package reads the other's: rvdd_tpu's ``load_checkpoint`` reads the
  port's files with ``flax.serialization.from_bytes``;
* ``<epoch>_optim_Denoise.pt``: the port's optimizer state,
  ``torch.save(optimizer.state_dict())``.  rvdd_tpu writes its optax state
  to ``<epoch>_optim_Denoise.msgpack``, which the port does not read: a
  port run resumed from an rvdd_tpu run directory loads its params and
  restarts the optimizer's moments, as the reference's autoresume does;
* ``status.json``: the last saved epoch and the best validation loss;
* the reference's released ``.pth`` state dicts (a ``.pth`` path, or a
  reference-style prefix ``<path2epoch>_net_Denoise.pth``) load through
  models/convert.py:load_torch_checkpoint.
"""

from __future__ import annotations

import json
import os
import struct
from os.path import isfile, join
from typing import Any, Dict, Optional

import numpy as np
import torch

from rvdd_tpu_torch.models.convert import (
    check_state_dict,
    convnext_from_flax,
    convnext_to_flax,
    convunet_from_flax,
    convunet_to_flax,
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


class _Writer:
    """A msgpack encoder for what flax writes, in msgpack-python's smallest
    encodings (``packb(..., use_bin_type=True)``): nil, booleans, integers,
    floats (as doubles), strings, binaries, lists and tuples (as arrays),
    maps with string keys, and numpy arrays and scalars as flax's ext
    types 1 and 3."""

    def __init__(self):
        self.out = bytearray()

    def put(self, fmt: str, *v) -> None:
        self.out += struct.pack(">" + fmt, *v)

    def head(self, n: int, fix: int, fix_max: int, codes) -> None:
        """A length header: the fix form below ``fix_max``, else the 8-, 16-
        or 32-bit form (``codes`` = their type bytes; None where absent)."""
        if n < fix_max:
            self.put("B", fix | n)
            return
        for code, fmt, lim in zip(codes, "BHI", (1 << 8, 1 << 16, 1 << 32)):
            if code is not None and n < lim:
                self.put("B" + fmt, code, n)
                return
        raise ValueError("msgpack: object too large")

    def value(self, v) -> None:
        if v is None:
            self.put("B", 0xC0)
        elif v is True or v is False:
            self.put("B", 0xC3 if v else 0xC2)
        elif type(v) is int:
            self.integer(v)
        elif type(v) is float:
            self.put("Bd", 0xCB, v)
        elif type(v) is str:
            b = v.encode("utf-8")
            self.head(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            self.out += b
        elif isinstance(v, (bytes, bytearray)):
            self.head(len(v), 0, 0, (0xC4, 0xC5, 0xC6))
            self.out += v
        elif type(v) in (list, tuple):
            self.head(len(v), 0x90, 16, (None, 0xDC, 0xDD))
            for x in v:
                self.value(x)
        elif type(v) is dict:
            if any(type(k) is not str for k in v):
                raise TypeError(f"msgpack: map keys must be strings, got {list(v)}")
            # sorted, as flax's copy of the tree through jax.tree_util sorts
            self.head(len(v), 0x80, 16, (None, 0xDE, 0xDF))
            for k in sorted(v):
                self.value(k)
                self.value(v[k])
        elif isinstance(v, np.ndarray):
            self.ext(_EXT_NDARRAY, v)
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, np.asarray(v))
        else:
            raise TypeError(f"msgpack: cannot encode {type(v).__name__}")

    def integer(self, v: int) -> None:
        if -32 <= v < 128:
            self.put("b" if v < 0 else "B", v)
            return
        forms = ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16), (0xCE, "I", 1 << 32),
                 (0xCF, "Q", 1 << 64)) if v >= 0 else (
            (0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15), (0xD2, "i", 1 << 31),
            (0xD3, "q", 1 << 63))
        for code, fmt, lim in forms:
            if (v < lim if v >= 0 else v >= -lim):
                self.put("B" + fmt, code, v)
                return
        raise ValueError(f"msgpack: integer {v} out of range")

    def ext(self, code: int, arr: np.ndarray) -> None:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not supported")
        if arr.nbytes > _MAX_LEAF:
            raise ValueError("msgpack: leaves over 1 GiB (chunked arrays) are not supported")
        inner = _Writer()
        inner.value([[int(n) for n in arr.shape], arr.dtype.name, arr.tobytes("C")])
        payload = bytes(inner.out)
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.put("B", fixed[n])
        else:
            self.head(n, 0, 0, (0xC7, 0xC8, 0xC9))
        self.put("b", code)
        self.out += payload


#: flax chunks leaves above this size (serialization.MAX_CHUNK_SIZE)
_MAX_LEAF = 2 ** 30


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize without msgpack or flax, for
    trees of dicts (keys sorted), lists, python scalars and numpy leaves
    below 1 GiB: the same bytes."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


def _net_file(save_dir: str, epoch: str, name: str = "Denoise") -> str:
    return join(save_dir, f"{epoch}_net_{name}.msgpack")


def _opt_file(save_dir: str, epoch: str, name: str = "Denoise") -> str:
    return join(save_dir, f"{epoch}_optim_{name}.pt")


def flax_params(net: torch.nn.Module) -> dict:
    """``net``'s weights as rvdd_tpu's flax params (nested dict of numpy
    arrays, HWIO kernels)."""
    conv = convnext_to_flax if isinstance(net, ConvNeXtUNet) else convunet_to_flax
    return conv(net.state_dict())


def save_checkpoint(save_dir: str, epoch: str, net: torch.nn.Module, optimizer=None) -> None:
    """``<epoch>_net_Denoise.msgpack`` (flax's layout) and, given an
    optimizer, ``<epoch>_optim_Denoise.pt``."""
    os.makedirs(save_dir, exist_ok=True)
    with open(_net_file(save_dir, epoch), "wb") as f:
        f.write(msgpack_serialize(flax_params(net)))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), _opt_file(save_dir, epoch))


def state_dict_from_flax(params, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """rvdd_tpu's flax params -> ``net``'s state_dict, checked."""
    conv = convnext_from_flax if isinstance(net, ConvNeXtUNet) else convunet_from_flax
    sd = conv(params)
    check_state_dict(sd, net)
    return sd


def load_checkpoint(path_or_dir: str, epoch: Optional[str], net: torch.nn.Module,
                    optimizer=None) -> bool:
    """Load weights into ``net`` (in place, on its device), and, given an
    optimizer and an epoch whose ``<epoch>_optim_Denoise.pt`` exists, its
    state.  Returns whether an optimizer state was loaded.

    Accepts:
    * (save_dir, epoch) pairs -> ``<epoch>_net_Denoise.msgpack`` written by
      either package's save_checkpoint, or ``<epoch>_net_Denoise.pth``;
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
    if optimizer is None or epoch is None or not isfile(_opt_file(path_or_dir, epoch)):
        return False
    dev = next(net.parameters()).device
    optimizer.load_state_dict(torch.load(_opt_file(path_or_dir, epoch), map_location=dev,
                                         weights_only=True))
    return True


def save_status(save_dir: str, status: dict) -> None:
    os.makedirs(save_dir, exist_ok=True)
    with open(join(save_dir, "status.json"), "w") as f:
        json.dump(status, f)


def load_status(save_dir: str) -> Optional[dict]:
    p = join(save_dir, "status.json")
    if not isfile(p):
        return None
    with open(p) as f:
        return json.load(f)
