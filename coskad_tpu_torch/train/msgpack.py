"""The subset of flax's msgpack format that checkpoints use, in pure Python.

Counterpart of `flax.serialization.msgpack_serialize` / `msgpack_restore`,
without the `msgpack` package. What is encoded and decoded:

- nil, bool, int (up to 64 bits), float (written as float64), str, bytes
  (bin), lists and tuples (arrays) and dicts with str keys (maps);
- numpy arrays as ext type 1, whose payload is itself msgpack:
  `(shape, dtype.name, bytes in C order)`;
- numpy scalars as ext type 3, the same payload of a 0-d array, decoded
  as `arr[()]`.

Flax writes tuples as maps keyed "0", "1", ... and empty named tuples as
`{}`: callers build such trees themselves, and `{}` round-trips. Map keys
are written sorted, and every length and integer in its shortest form, as
flax and msgpack-python do, so a tree encodes to the bytes flax writes. Complex
numbers (ext type 2) and flax's chunked arrays (leaves over 1 GiB) are not
supported; checkpoints of this model hold neither.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------- encoding


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= hi:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit 64 bits")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit 64 bits")


def _pack_len(n: int, out: bytearray, fix: Tuple[int, int], codes: Tuple[int, ...]) -> None:
    """Header of a str / bin / array / map of length n: the fix form when
    n < fix[1], else the 8-, 16- or 32-bit length form (codes, None where a
    family has no 8-bit form)."""
    fix_base, fix_limit = fix
    if fix_base is not None and n < fix_limit:
        out.append(fix_base | n)
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit 32 bits")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {n: c for c, n in _FIXEXT.items()}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, (None, 0), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):  # before int / float: np.float64 is a float
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, (None, 0), (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        bad = [k for k in obj if not isinstance(k, str)]
        if bad:
            raise TypeError(f"map keys must be str, got {type(bad[0]).__name__}")
        _pack_len(len(obj), out, (0x80, 16), (None, 0xDE, 0xDF))
        for k in sorted(obj):  # flax's tree walk sorts keys
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(obj: Any) -> bytes:
    """One msgpack object -> bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------- decoding


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# the length field of bin (C4-C6), ext (C7-C9), str (D9-DB), array (DC, DD)
# and map (DE, DF)
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (the ndarray payload) or decoded

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _SCALARS:
            return self.unpack(_SCALARS[c])
        if c in _FIXEXT:
            return self.ext(_FIXEXT[c])
        if c in _LENGTHS:
            n = self.unpack(_LENGTHS[c])
            if c <= 0xC6:
                return self.take(n)
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            return self.array(n) if c <= 0xDD else self.map_(n)
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Reader(data, raw=True).read()
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 arrays are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode("ascii")))
    return arr.reshape(shape, order="C").copy()


def unpackb(data: bytes) -> Any:
    """Bytes of one msgpack object -> the object; raises on trailing bytes."""
    reader = _Reader(data, raw=False)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after msgpack data")
    return obj
