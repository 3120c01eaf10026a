"""Picker checkpoints in the reference's file format (the port of
``repic_tpu.models.checkpoint``), without flax or msgpack.

A checkpoint is the ``MAGIC`` line followed by a msgpack map
``{"meta_json": str, "params": {...}}`` as flax's
``msgpack_serialize`` writes it: dict keys sorted at every level,
ndarray leaves as msgpack extension type 1 holding the msgpack array
``(shape, dtype name, C-order bytes)``.  :func:`_pack` / :func:`_unpack`
are a codec of the msgpack subset those files use (nil, booleans,
integers, floats, str, bin, arrays, maps, extension types 1 and 3), so
the port reads every file the reference writes and writes the same
bytes.

:func:`params_from_jax` turns the reference's parameter tree (HWIO conv
kernels, ``(in, out)`` dense kernels) into the port's state dict
(OIHW, ``(out, in)``).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

MAGIC = b"RPTPU1\n"

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# -- msgpack, the subset flax's files use -------------------------------


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n < 1 << 8:
        head = bytes([0xC7, n])
    elif n < 1 << 16:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack("b", code) + data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return _pack((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj) -> bytes:
    """msgpack bytes of ``obj`` with msgpack-python's (minimal) formats;
    ndarrays and numpy scalars become flax's extension types."""
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(EXT_NDARRAY, _array_payload(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    if isinstance(obj, int):
        if 0 <= obj < 0x80:
            return bytes([obj])
        if -32 <= obj < 0:
            return struct.pack("b", obj)
        if obj >= 0:
            for code, fmt, lim in ((0xCC, ">B", 1 << 8),
                                   (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32),
                                   (0xCF, ">Q", 1 << 64)):
                if obj < lim:
                    return bytes([code]) + struct.pack(fmt, obj)
        else:
            for code, fmt, lim in ((0xD0, ">b", 1 << 7),
                                   (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31),
                                   (0xD3, ">q", 1 << 63)):
                if obj >= -lim:
                    return bytes([code]) + struct.pack(fmt, obj)
        raise OverflowError(f"integer {obj} does not fit msgpack")
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            head = bytes([0xA0 | n])
        elif n < 1 << 8:
            head = bytes([0xD9, n])
        elif n < 1 << 16:
            head = b"\xda" + struct.pack(">H", n)
        else:
            head = b"\xdb" + struct.pack(">I", n)
        return head + raw
    if isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 1 << 8:
            head = bytes([0xC4, n])
        elif n < 1 << 16:
            head = b"\xc5" + struct.pack(">H", n)
        else:
            head = b"\xc6" + struct.pack(">I", n)
        return head + bytes(obj)
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            head = bytes([0x90 | n])
        elif n < 1 << 16:
            head = b"\xdc" + struct.pack(">H", n)
        else:
            head = b"\xdd" + struct.pack(">I", n)
        return head + b"".join(_pack(v) for v in obj)
    if isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            head = bytes([0x80 | n])
        elif n < 1 << 16:
            head = b"\xde" + struct.pack(">H", n)
        else:
            head = b"\xdf" + struct.pack(">I", n)
        return head + b"".join(_pack(k) + _pack(v) for k, v in obj.items())
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def _array_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = _unpack(data, raw=True)
    try:
        dtype = np.dtype(dtype_name.decode())
    except TypeError:
        raise ValueError(
            f"array dtype {dtype_name!r} has no numpy equivalent"
        ) from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",   # str
                 0xDC: ">H", 0xDD: ">I",               # array
                 0xDE: ">H", 0xDF: ">I",               # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n)
            if b >= 0xD9 and b <= 0xDB:
                return self.text(n)
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.mapping(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _unpack(data: bytes, raw: bool = False):
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack data")
    return out


# -- the checkpoint file ------------------------------------------------


def _sorted_tree(tree):
    """Dicts with keys sorted at every level and array leaves as numpy,
    the order flax's tree map gives the serialized map."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, str):
        return tree
    return np.asarray(tree)


def save_checkpoint(path: str, params, meta: dict) -> None:
    """Write params (the reference's tree layout) + metadata; published
    with one rename."""
    blob = _pack(_sorted_tree(
        {"params": params, "meta_json": json.dumps(meta)}
    ))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns ``(params, meta)``: the reference's parameter tree with
    numpy leaves, and the metadata dict."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head != MAGIC:
            raise ValueError(
                f"{path}: not a repic-tpu checkpoint (bad magic {head!r})"
            )
        tree = _unpack(f.read())
    return tree["params"], json.loads(tree["meta_json"])


def params_from_jax(tree, prefix: str = "") -> dict:
    """The port's state dict of a reference parameter tree (nested dict
    of numpy arrays): ``kernel`` becomes ``weight`` -- HWIO conv kernels
    as OIHW, ``(in, out)`` dense kernels as ``(out, in)`` -- and
    ``bias`` stays; keys join the tree's path with dots."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(params_from_jax(val, name + "."))
            continue
        t = torch.from_numpy(np.array(val, dtype=np.float32))
        if key == "kernel":
            name = f"{prefix}weight"
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
        out[name] = t.contiguous()
    return out
