"""A reader of flax's msgpack checkpoints, in plain Python and numpy.

The JAX package writes its single-file checkpoint with
`flax.serialization.to_bytes`: the state dict of the payload (every key a
string) packed by msgpack, each array an ext-type record.  This module
reads such bytes without flax or msgpack, as `flax.serialization.
msgpack_restore` does:

- every msgpack type: nil, bool, ints and floats of every width, str, bin,
  array, map and ext in all their lengths;
- ext 1, an ndarray: its payload is msgpack [shape, dtype name, C-order
  bytes], read as a numpy array (a copy: the file's bytes are not kept);
  the dtype name "bfloat16", which numpy lacks, gives a torch.bfloat16
  tensor;
- ext 3, a numpy scalar (the same payload, 0-d);
- ext 2, a Python complex, raises NotImplementedError;
- flax splits a leaf larger than its MAX_CHUNK_SIZE into a map
  {"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ...}}; such maps are joined back into one array.

`read(path)` or `unpackb(data)` return the nested dicts of the payload.
"""
import struct

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
# fixed-width types: first byte -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
          0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
          0xd2: (">i", 4), 0xd3: (">q", 8)}
# first byte -> (kind, width of the length field) for str, bin, array, map, ext
_SIZED = {0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4), 0xde: ("map", 2), 0xdf: ("map", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4)}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width):
        return struct.unpack(_UINT[width], self.take(width))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if 0xd4 <= b <= 0xd8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xd4))
        if b in _SIZED:
            kind, width = _SIZED[b]
            return getattr(self, kind)(self.uint(width))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} begins no msgpack object")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n):
        return bytes(self.take(n))

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code == _NDARRAY:
            return _ndarray(payload)
        if code == _NPSCALAR:
            return _ndarray(payload)[()]
        if code == _COMPLEX:
            raise NotImplementedError("msgpack ext 2 (a Python complex) is not read")
        raise ValueError(f"unknown msgpack ext type {code}")


def _ndarray(payload):
    """flax's ndarray record: msgpack [shape, dtype name, C-order bytes]."""
    shape, name, buf = _Reader(payload).obj()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """The chunked leaves of `tree` (nested dicts) joined back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data):
    """The object that msgpack bytes `data` (a flax checkpoint) hold."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return _unchunk(out)


def read(path):
    """The payload of the flax msgpack file at `path`, as nested dicts."""
    with open(path, "rb") as f:
        return unpackb(f.read())
