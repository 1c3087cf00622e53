"""Read the JAX package's checkpoints without msgpack or flax (counterpart of
load_params and get_best_model in caster_dta_tpu/train/checkpoints.py).

Flax writes params with ``flax.serialization.to_bytes``: a msgpack map of
module names down to array leaves. Each array is msgpack ext type 1 whose
payload is itself a msgpack array ``[shape, dtype_name, raw_bytes]``, C order,
little-endian; ext type 3 is a numpy scalar in the same encoding. The reader
below covers the msgpack subset that such a file uses: maps, arrays, str,
bin, int, float, nil, bool and ext.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _bfloat16_to_f32(raw: bytes, shape) -> np.ndarray:
    bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32).reshape(shape)


def _decode_ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(payload).read()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(shape)
    if dtype_name == "bfloat16":  # numpy has no bfloat16: widen exactly to f32
        return _bfloat16_to_f32(raw, shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name).newbyteorder("<")).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k.decode() if isinstance(k, bytes) else k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code == _EXT_NDARRAY:
            return _decode_ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _decode_ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        t = self._unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self._take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return self._take(n).decode()
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self._unpack(numbers[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def unpackb(data: bytes):
    """Decode one msgpack object (with flax's ndarray ext) from bytes."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after msgpack object")
    return out


def load_params(path: str) -> dict:
    """A flax ``.msgpack`` checkpoint -> nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def get_best_model(checkpoint_path: str, use_best: str = "val") -> str:
    """The best checkpoint file of a run directory, by the reference's name
    prefixes (sorted, first wins), or the path itself when it is a file."""
    if os.path.isdir(checkpoint_path):
        prefixes = {"val": ("bestvalmodel", "bestmodel"),
                    "train": ("besttrainmodel",),
                    "final": ("finalmodel",)}[use_best]
        names = [x for x in sorted(os.listdir(checkpoint_path))
                 if x.startswith(prefixes) and x.endswith(".msgpack")]
        if not names:
            raise FileNotFoundError(f"no {use_best} .msgpack checkpoint in {checkpoint_path}")
        return os.path.join(checkpoint_path, names[0])
    if os.path.isfile(checkpoint_path):
        return checkpoint_path
    raise FileNotFoundError(f"invalid checkpoint path {checkpoint_path}")
