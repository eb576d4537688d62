"""A reader of tensorstore's OCDBT key-value store, in Python, and a
writer of the one layout the tests need.

orbax writes the JAX package's multi-process checkpoints (`utils/
orbax_dir.py`) into an OCDBT database: an append-only B-tree of byte-string
keys, each value held inline in a leaf or as a byte range of a data file.
This module reads one without tensorstore:

- the root manifest `manifest.ocdbt` (the "single" manifest kind): the
  config, a data-file table, and the version tree's newest leaf entries
  inline.  The newest version's root node is the tree to read;
- B-tree nodes, at (data file, offset, length): height 0 is a leaf of
  (key, value) entries, above that an interior node of (key, subtree
  common prefix length, child node) entries.  A child's keys omit the
  prefix its parent's entry names;
- every file, manifest or node, is framed the same way: a big-endian
  4-byte magic (0x0cdb3a2a a manifest, 0x0cdb20de a node), a
  little-endian uint64 length of the whole frame, varints version (0) and
  compression (0 none, 1 zstd), the body, and a little-endian crc32c of
  all that precedes it;
- columns, not records: each table stores one field for every entry,
  then the next field.  Keys are coded against the entry before: a
  prefix length (entries after the first), a suffix length, in an
  interior node the subtree common prefix length, then the suffixes'
  bytes;
- a data-file table names each file as a base path and a relative path;
  their concatenation is the file's path from the database's root
  directory (a merged multi-process tree reaches `ocdbt.process_<i>/d/...`
  from the root this way).

`OcdbtReader(root).keys()` lists the keys (bytes, sorted) and
`.read(key)` returns a value's bytes.  A magic, version, compression,
manifest kind, value kind or checksum this reader does not know raises
OcdbtError naming the file and the byte offset.

`write_multi_process(root, per_process)` writes the database orbax's
multi-process save leaves (one leaf node per process and a merged root),
for `testing.write_orbax_checkpoint`; it is a test writer, not a general
one.
"""
import hashlib
import os
import struct
import time

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NONE, _ZSTD = 0, 1  # the frames' compression
_INLINE, _INDIRECT = 0, 1


class OcdbtError(ValueError):
    pass


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of `data`, as OCDBT's footers hold it."""
    c = 0xFFFFFFFF
    for byte in data:
        c = _CRC32C[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Sequential reads from a node's or manifest's decoded body; errors
    name the file and the frame's offset in it."""

    def __init__(self, body, where):
        self.body, self.pos, self.where = body, 0, where

    def fail(self, what):
        raise OcdbtError(f"{self.where}, body byte {self.pos}: {what}")

    def take(self, n):
        if self.pos + n > len(self.body):
            self.fail(f"{n} bytes past the end of the {len(self.body)}-byte body")
        out = self.body[self.pos:self.pos + n]
        self.pos += n
        return out

    def varint(self):
        value = shift = 0
        while True:
            byte = self.take(1)[0]
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def u8(self):
        return self.take(1)[0]

    def end(self):
        if self.pos != len(self.body):
            self.fail(f"{len(self.body) - self.pos} bytes left over")


def decode_frame(data, magic, where):
    """The body of an OCDBT frame `data` that must start with `magic`;
    `where` names the file and offset in errors."""
    if len(data) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{where}: {len(data)} bytes, too short for an OCDBT frame")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise OcdbtError(f"{where}: magic {got:#010x}, not {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise OcdbtError(f"{where}: the frame states {length} bytes, the reference {len(data)}")
    head = _Cursor(data[12:], where)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{where}: unknown OCDBT format version {version}")
    if compression not in (_NONE, _ZSTD):
        raise OcdbtError(f"{where}: unknown OCDBT compression {compression}")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise OcdbtError(f"{where}: crc32c mismatch")
    body = data[12 + head.pos:-4]
    return zstd.decompress(body) if compression == _ZSTD else bytes(body)


def _prefix_coded(cur, n, interior=False):
    """n keys coded as prefix lengths (after the first), suffix lengths and
    the suffixes; an interior node's subtree common prefix lengths come
    between the suffix lengths and the suffixes.  Returns the keys, and
    with `interior` also the common prefix lengths."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else None
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail(f"prefix length {p} past the previous entry's {len(prev)} bytes")
        prev = prev[:p] + cur.take(s)
        out.append(prev)
    return (out, common) if interior else out


def _data_file_table(cur):
    """Each data file's path from the root: its base path + relative path."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        prev = prev[:p] + cur.take(s)
        if b > len(prev):
            cur.fail(f"base path length {b} past the path's {len(prev)} bytes")
        paths.append(prev.decode())
    return paths


def _file_of(cur, files, i):
    if i >= len(files):
        cur.fail(f"data file {i} of a table of {len(files)}")
    return files[i]


class OcdbtReader:
    """The keys and values of the OCDBT database in directory `root`, as of
    its newest version."""

    def __init__(self, root):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            data = f.read()
        cur = _Cursor(decode_frame(data, MANIFEST_MAGIC, f"{path} at byte 0"), path)
        cur.take(16)  # the database's uuid
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind}: only the single-file manifest (0) is read")
        cur.varint()  # max_inline_value_bytes
        cur.varint()  # max_decoded_node_bytes
        cur.u8()  # version_tree_arity_log2
        if cur.varint() == _ZSTD:  # the nodes' compression method: zstd has a level
            cur.take(4)
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            cur.fail("no version in the manifest")
        generation = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        last = max(range(n), key=generation.__getitem__)
        self._values = {}
        if num_keys[last]:
            self._walk(_file_of(cur, files, file_id[last]), offset[last], length[last],
                       height[last], b"")

    def _node(self, rel, offset, length):
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        where = f"{path} at byte {offset}"
        if len(data) != length:
            raise OcdbtError(f"{where}: {len(data)} of {length} bytes")
        return _Cursor(decode_frame(data, NODE_MAGIC, where), where)

    def _walk(self, rel, offset, length, height, prefix):
        cur = self._node(rel, offset, length)
        got = cur.u8()
        if got != height:
            cur.fail(f"node height {got}, its reference says {height}")
        files = _data_file_table(cur)
        n = cur.varint()
        if height == 0:
            keys = _prefix_coded(cur, n)
            lengths, kinds = cur.varints(n), cur.varints(n)
            unknown = set(kinds) - {_INLINE, _INDIRECT}
            if unknown:
                cur.fail(f"unknown value kind {min(unknown)}")
            indirect = kinds.count(_INDIRECT)
            file_id, offsets = cur.varints(indirect), cur.varints(indirect)
            refs = iter(zip(file_id, offsets))
            for key, size, kind in zip(keys, lengths, kinds):
                if kind == _INDIRECT:
                    i, off = next(refs)
                    self._values[prefix + key] = (_file_of(cur, files, i), off, size)
                else:
                    self._values[prefix + key] = cur.take(size)
            cur.end()
            return
        keys, common = _prefix_coded(cur, n, interior=True)
        file_id, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # each subtree's keys, tree bytes and indirect value bytes
        cur.end()
        for key, c, i, off, size in zip(keys, common, file_id, offsets, lengths):
            if c > len(key):
                cur.fail(f"subtree common prefix {c} past its key's {len(key)} bytes")
            self._walk(_file_of(cur, files, i), off, size, height - 1, prefix + key[:c])

    def keys(self):
        """Every key, as bytes, in order."""
        return sorted(self._values)

    def __contains__(self, key):
        return (key.encode() if isinstance(key, str) else key) in self._values

    def read(self, key):
        """The value of `key` (str or bytes) as bytes; KeyError if absent."""
        k = key.encode() if isinstance(key, str) else key
        value = self._values[k]
        if isinstance(value, bytes):
            return value
        rel, offset, size = value
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(size)
        if len(data) != size:
            raise OcdbtError(f"{path} at byte {offset}: {len(data)} of the value's {size} bytes")
        return data


# ----------------------------------- the test writer: orbax's multi-process layout

INLINE_BYTES = 1024  # OCDBT's max_inline_value_bytes, as orbax configures it


def _varints(values):
    out = bytearray()
    for v in values:
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
    return bytes(out)


def _frame(magic, body):
    """An OCDBT file: magic, length, version 0, zstd (1), the body as a
    zstd frame, crc32c."""
    packed = zstd.compress(body, 0)
    head = struct.pack(">I", magic)
    size = len(head) + 8 + 2 + len(packed) + 4
    data = head + struct.pack("<Q", size) + _varints([0, _ZSTD]) + packed
    return data + struct.pack("<I", crc32c(data))


def _prefix_columns(strings):
    """Prefix lengths (after the first) and suffix lengths of sorted byte
    strings, and their suffixes."""
    prefix, suffix, tails = [], [], []
    prev = b""
    for i, s in enumerate(strings):
        p = 0
        if i:
            while p < min(len(s), len(prev)) and s[p] == prev[p]:
                p += 1
            prefix.append(p)
        suffix.append(len(s) - p)
        tails.append(s[p:])
        prev = s
    return prefix, suffix, b"".join(tails)


def _file_table(files):
    """files: (base path, relative path) strings."""
    full = [(b + r).encode() for b, r in files]
    prefix, suffix, tails = _prefix_columns(full)
    return _varints([len(files)] + prefix + suffix + [len(b.encode()) for b, _ in files]) + tails


def _leaf(values, files):
    """A leaf node of `values`: key -> bytes (inline) or (file index,
    offset, length) into `files`."""
    keys = sorted(values)
    prefix, suffix, tails = _prefix_columns(keys)
    refs = [values[k] for k in keys]
    lengths = [len(v) if isinstance(v, bytes) else v[2] for v in refs]
    kinds = [0 if isinstance(v, bytes) else 1 for v in refs]
    indirect = [v for v in refs if not isinstance(v, bytes)]
    body = (bytes([0]) + _file_table(files) + _varints([len(keys)] + prefix + suffix)
            + tails + _varints(lengths + kinds + [v[0] for v in indirect]
                               + [v[1] for v in indirect])
            + b"".join(v for v in refs if isinstance(v, bytes)))
    return _frame(NODE_MAGIC, body)


def _manifest(node_file, node_length, values, seed):
    """A single-file manifest whose one version's root is the leaf node
    filling `node_file` (a path from the database's root)."""
    indirect = sum(v[2] for v in values.values() if not isinstance(v, bytes))
    body = (hashlib.md5(seed).digest() + _varints([0, INLINE_BYTES, 100_000_000])
            + bytes([4]) + _varints([1]) + struct.pack("<i", 0)
            + _file_table([("", node_file)])
            + _varints([1, 1]) + bytes([0])
            + _varints([0, 0, node_length, len(values), node_length, indirect])
            + struct.pack("<Q", time.time_ns()) + _varints([0]))
    return _frame(MANIFEST_MAGIC, body)


def write_multi_process(root, per_process):
    """The OCDBT database orbax's multi-process save leaves in `root`:
    per process i (`per_process[i]`, key -> value bytes) a value file and
    a leaf node under ocdbt.process_<i>/d/ with their manifest, then the
    root's merged leaf node under d/, reaching the processes' value files
    through its data-file table, and the root manifest."""
    def write(rel, data):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        return rel

    def name(data):
        return "d/" + hashlib.md5(data).hexdigest()

    merged, files = {}, []
    for i, entries in enumerate(per_process):
        base = f"ocdbt.process_{i}/"
        blob, local = bytearray(), {}
        for key, value in sorted(entries.items()):
            if len(value) <= INLINE_BYTES:
                local[key] = value
            else:
                local[key] = (0, len(blob), len(value))
                blob += value
        values_file = name(bytes(blob))
        if blob:
            write(base + values_file, bytes(blob))
        node = _leaf(local, [("", values_file)] if blob else [])
        node_file = write(base + name(node), node)[len(base):]
        write(base + "manifest.ocdbt", _manifest(node_file, len(node), local, base.encode()))
        for key, v in local.items():
            merged[key] = v if isinstance(v, bytes) else (len(files), v[1], v[2])
        if blob:
            files.append((base, values_file))
    node = _leaf(merged, files)
    node_file = write(name(node), node)
    write("manifest.ocdbt", _manifest(node_file, len(node), merged, b"root"))
