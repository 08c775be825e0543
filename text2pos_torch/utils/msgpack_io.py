"""Pure-Python reader and writer of flax's msgpack checkpoints.

Counterparts of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize`` as used by ``text2pos_tpu/train/state.py`` and
``bench.py:278``: the card machine has neither ``flax`` nor ``msgpack``, so
the port decodes and encodes the format itself. The writer packs as
``msgpack.packb(tree, default=flax's ext hook, strict_types=True)`` does, so
both packages write the same bytes for the same tree.

Covers maps, arrays, str, bin, nil/bool, ints, floats and ext types. Flax
packs an ndarray as ext code 1 whose payload is a msgpack array
``(shape, dtype_name, buffer)``; code 2 is a Python complex ``(re, im)`` and
code 3 a numpy scalar (an ndarray payload unpacked to ``arr[()]``). Arrays
larger than 1 GiB are stored as ``__msgpack_chunked_array__`` maps and are
joined back here. ``bfloat16`` leaves, which numpy cannot hold, come back
as float32 (exact).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.str_(n)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object (``msgpack.unpackb`` with flax's ext
    hook). ``raw=True`` leaves str values as bytes."""
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after object")
    return out


def _dtype(name: bytes) -> Tuple[np.dtype, bool]:
    if name == b"bfloat16":
        return np.dtype(np.uint16), True
    return np.dtype(name.decode("ascii")), False


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    dt, is_bf16 = _dtype(dtype_name)
    arr = np.frombuffer(buffer, dtype=dt).reshape(shape, order="C")
    if is_bf16:  # bf16 is the top half of an f32 bit pattern
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d: Any) -> Any:
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_tree(v)
    return d


def msgpack_restore(encoded: bytes) -> Any:
    """Restore a flax-serialized tree: nested dicts with numpy leaves."""
    return _unchunk_tree(unpackb(encoded))


MAX_CHUNK_SIZE = 2 ** 30


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack(">B", n)
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    if 0x80 <= n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack(">b", n)
    if 0xFF < n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < -0x80:
        return b"\xd1" + struct.pack(">h", n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < -0x8000:
        return b"\xd2" + struct.pack(">i", n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < -0x80000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fixmax: int, codes) -> bytes:
    """Header of a str/bin/array/map/ext of length n: a fix form below
    ``fixmax`` (when ``fix`` is not None), else 8/16/32-bit lengths."""
    if fix is not None and n < fixmax:
        return struct.pack(">B", fix | n)
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= lim:
            return struct.pack(">B", code) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = struct.pack(">B", fixext[n])
    else:
        head = _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def packb(obj: Any, strict: bool = False) -> bytes:
    """Encode one object as ``msgpack.packb`` (use_bin_type) does, numpy
    arrays and scalars and complex numbers as flax's ext types. ``strict``
    is msgpack's ``strict_types``: a tuple is then not a list, and goes
    through the ext hook (which refuses it)."""
    out = []
    _pack(obj, out, strict)
    return b"".join(out)


def _pack(obj: Any, out: list, strict: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_pack_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        b = obj.encode("utf-8")
        out.append(_pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b)
    elif t in (bytes, bytearray, memoryview):
        b = bytes(obj)
        out.append(_pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b)
    elif t is list or (t is tuple and not strict):
        out.append(_pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out, strict)
    elif t is dict:
        out.append(_pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    elif t is complex:
        out.append(_pack_ext(_EXT_COMPLEX, packb((obj.real, obj.imag))))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in
                       enumerate(range(0, flat.size, size))}}


def _chunk_tree(d: Any) -> Any:
    if isinstance(d, dict):     # keys sorted, as flax's tree_map leaves them
        return {k: _chunk_tree(d[k]) for k in sorted(d)}
    if isinstance(d, np.ndarray) and d.size * d.dtype.itemsize \
            > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts, lists, Python scalars and numpy leaves as
    ``flax.serialization.msgpack_serialize``: map keys sorted, arrays above
    1 GiB as ``__msgpack_chunked_array__`` maps, then packed with strict
    types."""
    return packb(_chunk_tree(tree), strict=True)
