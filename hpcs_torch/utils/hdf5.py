"""HDF5 files read and written in plain Python and numpy, without h5py.

Worked from the HDF5 File Format Specification, version 3.0.  What PartNet's
`sem_seg_h5` files need, in any storage layout that h5py writes by default,
with compression, or with libver "latest":

Read (`File(path)["data"][...]`: an ndarray of the stored dtype and shape):
- superblocks of version 0 and 1 (h5py's default, libver "earliest") and of
  version 2 and 3 (libver "latest"), a user block before them included;
- groups as symbol tables (v1 B-tree of group nodes, local heap, symbol
  table nodes), as link messages in the object header (compact storage),
  or in dense storage: the link info message's fractal heap (direct and
  indirect blocks under its doubling table, managed and tiny objects) and
  its version 2 B-tree of link names (or, where it is the only index, of
  creation order), each heap object a link message;
- object headers of version 1 and 2, with their continuation blocks;
- datasets: the dataspace (scalar or simple, unlimited dimensions
  included), the datatype (fixed-point of 1, 2, 4 or 8 bytes, signed or
  unsigned; IEEE float of 2, 4 or 8 bytes; either byte order), the layout
  (version 3 and 4: compact, contiguous, chunked), the chunk indexes of
  version 1 B-trees, single chunks, implicit and fixed arrays, extensible
  arrays (one unlimited dimension: header, index block, data blocks, paged
  ones with their page bitmap, super blocks) and version 2 B-trees (more
  than one unlimited dimension: records of type 10 and, filtered, 11, at
  any depth), edge chunks cut to the shape, chunks never written filled
  from the fill value message, and the filters deflate (`zlib`), shuffle
  and fletcher32 (its checksum checked);
- the lookup3 checksums of the version 2 formats' metadata, checked.

Anything else (another datatype class, soft or external links, huge
fractal heap objects, a filter on a fractal heap, edge chunks left
unfiltered, another filter, external or virtual storage) raises a
ValueError naming the feature and the file; a truncated or damaged
structure raises one as well.

Written (`write_h5(path, {name: array})`): superblock version 0, a root
group of up to 256 datasets as a symbol table, each dataset contiguous, of
the dtypes above: what h5py's `create_dataset(name, data=array)` writes, and
nothing else.
"""
import bisect
import contextlib
import math
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL = 0x1, 0x2, 0x3, 0x4, 0x5
LINK, EXTERNAL, LAYOUT, PIPELINE, CONTINUATION, SYMBOL_TABLE = 0x6, 0x7, 0x8, 0xB, 0x10, 0x11

DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3
FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
                32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
DATATYPE_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield", "opaque",
                    "compound", "reference", "enumerated", "variable-length", "array")
# IEEE floats by size: (bit offset, precision, exponent location and size,
# mantissa location and size, exponent bias, sign location)
IEEE = {2: (0, 16, 10, 5, 0, 10, 15, 15), 4: (0, 32, 23, 8, 0, 23, 127, 31),
        8: (0, 64, 52, 11, 0, 52, 1023, 63)}


class _Cursor:
    """Little-endian fields read in order from `data`, addresses and
    lengths at the file's sizes."""

    def __init__(self, data, pos, offsets, lengths):
        self.data, self.pos, self.offsets, self.lengths = data, pos, offsets, lengths

    def u(self, n):
        if self.pos + n > len(self.data):
            raise EOFError
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def take(self, n):
        if self.pos + n > len(self.data):
            raise EOFError
        self.pos += n
        return bytes(self.data[self.pos - n:self.pos])

    def addr(self):
        return self.u(self.offsets)

    def length(self):
        return self.u(self.lengths)


class Dataset:
    """A dataset of an open `File`: `shape`, `dtype`, and `ds[key]` (the
    whole array read, then indexed: `ds[...]` is the array)."""

    def __init__(self, file, name, messages):
        self.file, self.name = file, name
        self._messages = messages
        self.shape, self._maxshape = file._dataspace(_one(file, messages, DATASPACE, name), name)
        self.dtype = file._datatype(_one(file, messages, DATATYPE, name), name)

    def read(self):
        with self.file._reading(f"the data of {self.name}"):
            return self.file._read_dataset(self)

    def __getitem__(self, key):
        return self.read()[key]


class Group:
    """A group of an open `File`: its members by name."""

    def __init__(self, file, name, links):
        self.file, self.name, self._links = file, name, links

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __contains__(self, name):
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __getitem__(self, path):
        node = self
        for part in (p for p in path.split("/") if p and p != "."):
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {node.name} is a dataset")
            if part not in node._links:
                raise KeyError(f"{path!r}: no member {part!r} in {node.name} of {self.file.path}")
            kind, target = node._links[part]
            if kind != "hard":
                self.file._refuse(f"the {kind} link {part!r}")
            node = self.file._object(target, f"{node.name.rstrip('/')}/{part}")
        return node


def _one(file, messages, mtype, name):
    found = [m for m in messages if m[0] == mtype]
    if not found:
        file._refuse(f"a dataset without message type {mtype:#x} ({name})")
    if found[0][1] & 0x02:
        file._refuse(f"a shared message of type {mtype:#x} ({name})")
    return found[0][2]


class File(Group):
    """An HDF5 file opened for reading: `File(path)["data"][...]`, `keys()`,
    `with File(path) as f: ...`."""

    def __init__(self, path, mode="r"):
        if mode != "r":
            raise ValueError(f"{path}: hpcs_torch.utils.hdf5.File only reads (mode 'r')")
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
            self._objects = {}
            with self._reading("the superblock"):
                root = self._superblock()
            group = self._object(root, "/")
            if not isinstance(group, Group):
                self._refuse("a root object that is not a group")
        except BaseException:
            self._f.close()
            raise
        super().__init__(self, "/", group._links)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- errors and raw reads ------------------------------------------------

    def _refuse(self, feature):
        raise ValueError(f"{self.path}: {feature} is not read by hpcs_torch.utils.hdf5")

    def _damaged(self, what):
        raise ValueError(f"{self.path}: damaged or truncated HDF5 file ({what})")

    def _read(self, addr, n, absolute=False):
        start = addr if absolute else self._base + addr
        if start < 0 or n < 0 or start + n > self._size:
            self._damaged(f"{n} bytes at {addr} run past the file's {self._size}")
        data = os.pread(self._f.fileno(), n, start)
        if len(data) != n:
            self._damaged(f"short read at {addr}")
        return data

    def _cursor(self, addr, n):
        return _Cursor(self._read(addr, n), 0, self._offsets, self._lengths)

    def _checked(self, addr, n, what):
        """The n bytes at `addr`, which the version 2 formats follow with
        their Jenkins lookup3 checksum: checked here."""
        data = self._read(addr, n + 4)
        if lookup3(data[:n]) != int.from_bytes(data[n:], "little"):
            self._damaged(f"the checksum of {what} at {addr}")
        return data[:n]

    def _undefined(self, addr):
        return addr == (1 << (8 * self._offsets)) - 1

    @contextlib.contextmanager
    def _reading(self, what):
        """A field or structure that runs past its end, or past the file,
        reported as damage (a ValueError naming the file)."""
        try:
            yield
        except (EOFError, IndexError, struct.error, UnicodeDecodeError,
                ZeroDivisionError, OverflowError) as e:
            self._damaged(f"{what}: {type(e).__name__} {e}")

    # -- superblock and object headers ---------------------------------------

    def _superblock(self):
        at = 0  # after a user block of 512, 1024, 2048, ... bytes
        while True:
            if at + 8 > self._size:
                self._refuse("a file without the HDF5 signature")
            if self._read(at, 8, absolute=True) == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        head = self._read(at, min(256, self._size - at), absolute=True)
        version = head[8]
        if version in (0, 1):
            self._offsets, self._lengths = head[13], head[14]
            c = _Cursor(head, 24 + (4 if version == 1 else 0), self._offsets, self._lengths)

            def fields():
                base, _, _, _ = c.addr(), c.addr(), c.addr(), c.addr()
                c.addr()  # the root's link name offset
                return base, c.addr()
        elif version in (2, 3):
            self._offsets, self._lengths = head[9], head[10]
            end = 12 + 4 * self._offsets
            if lookup3(head[:end]) != int.from_bytes(head[end:end + 4], "little"):
                self._damaged("the superblock's checksum")
            c = _Cursor(head, 12, self._offsets, self._lengths)

            def fields():
                base, _, _, root = c.addr(), c.addr(), c.addr(), c.addr()
                return base, root
        else:
            self._refuse(f"superblock version {version}")
        if self._offsets not in (2, 4, 8) or self._lengths not in (2, 4, 8):
            self._damaged(f"sizes of offsets {self._offsets} and lengths {self._lengths}")
        # every address is relative to the superblock's (the library
        # takes that over the stored base address)
        self._base = at
        return fields()[1]

    def _header(self, addr):
        """[(type, flags, data)] of the object header at `addr`, its
        continuation blocks followed."""
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            return self._header_v2(addr)
        if prefix[0] != 1:
            self._refuse(f"object header version {prefix[0]} at {addr}")
        size = int.from_bytes(prefix[8:12], "little")
        blocks, messages, seen = [(addr + 16, size)], [], set()
        while blocks:
            start, n = blocks.pop(0)
            if start in seen:
                self._damaged(f"the object header at {addr} continues into itself")
            seen.add(start)
            data, pos = self._read(start, n), 0
            while pos + 8 <= n:
                mtype, msize, flags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                if len(body) != msize:
                    self._damaged(f"a message of the object header at {addr}")
                pos += 8 + msize
                messages.append((mtype, flags, body))
                if mtype == CONTINUATION:
                    blocks.append(self._continuation(body))
        return messages

    def _continuation(self, body):
        c = _Cursor(body, 0, self._offsets, self._lengths)
        return c.addr(), c.length()

    def _header_v2(self, addr):
        head = self._read(addr, min(6 + 16 + 4 + 8, self._size - self._base - addr))
        if head[4] != 2:
            self._refuse(f"object header version {head[4]} at {addr}")
        flags, pos = head[5], 6
        pos += 16 if flags & 0x20 else 0  # access, modification, change and birth times
        pos += 4 if flags & 0x10 else 0  # attribute storage phase change values
        width = 1 << (flags & 3)
        size = int.from_bytes(head[pos:pos + width], "little")
        blocks = [(addr, pos + width + size, pos + width)]  # chunk 0 after its prefix
        messages, order, seen = [], 2 if flags & 0x04 else 0, set()
        while blocks:
            start, n, skip = blocks.pop(0)
            if start in seen:
                self._damaged(f"the object header at {addr} continues into itself")
            seen.add(start)
            data = self._checked(start, n, f"the object header of {addr}")
            if data[:4] != (b"OHDR" if start == addr else b"OCHK"):
                self._damaged(f"an object header block at {start} without its signature")
            data = data[skip:]
            pos = 0
            while pos + 4 + order <= len(data):
                mtype, msize, mflags = data[pos], int.from_bytes(data[pos + 1:pos + 3],
                                                                 "little"), data[pos + 3]
                body = data[pos + 4 + order:pos + 4 + order + msize]
                if len(body) != msize:
                    self._damaged(f"a message of the object header at {addr}")
                pos += 4 + order + msize
                messages.append((mtype, mflags, body))
                if mtype == CONTINUATION:  # signature, messages, checksum
                    cont, length = self._continuation(body)
                    blocks.append((cont, length - 4, 4))
        return messages

    def _object(self, addr, name):
        if addr not in self._objects:
            with self._reading(f"the object header of {name}"):
                messages = self._header(addr)
                types = {m[0] for m in messages}
                if LAYOUT in types:
                    if EXTERNAL in types:
                        self._refuse(f"external storage ({name})")
                    obj = Dataset(self, name, messages)
                elif SYMBOL_TABLE in types:
                    obj = Group(self, name, self._symbol_table(
                        [m[2] for m in messages if m[0] == SYMBOL_TABLE][0]))
                elif LINK_INFO in types or LINK in types:
                    obj = Group(self, name, self._group_links(messages, name))
                else:
                    self._refuse(f"an object that is neither a dataset nor a group ({name})")
            self._objects[addr] = obj
        return self._objects[addr]

    # -- groups ----------------------------------------------------------------

    def _symbol_table(self, body):
        c = _Cursor(body, 0, self._offsets, self._lengths)
        btree, heap = c.addr(), c.addr()
        names = self._local_heap(heap)
        links = {}
        for snod in self._btree_children(btree, 0):
            for name_off, header in self._symbol_node(snod):
                end = names.find(b"\0", name_off)
                if name_off >= len(names) or end < 0:
                    self._damaged(f"a link name at heap offset {name_off}")
                links[names[name_off:end].decode("utf-8")] = ("hard", header)
        return links

    def _local_heap(self, addr):
        c = self._cursor(addr, 8 + 2 * self._lengths + self._offsets)
        if c.take(4) != b"HEAP":
            self._damaged(f"local heap at {addr} without its signature")
        c.take(4)
        size, _, data = c.length(), c.length(), c.addr()
        return self._read(data, size)

    def _btree_children(self, addr, node_type, rank=0, level=None):
        """The level-0 entries of the v1 B-tree at `addr`: group nodes
        (type 0) give symbol table node addresses; chunk nodes (type 1)
        (chunk offsets, stored size, filter mask, address).  Each child
        node lies one level below its parent."""
        head = self._read(addr, 8 + 2 * self._offsets)
        if head[:4] != b"TREE" or head[4] != node_type or level not in (None, head[5]):
            self._damaged(f"B-tree node at {addr} (signature {head[:4]!r}, type {head[4]}, "
                          f"level {head[5]} where {level} was due)")
        level, used = head[5], int.from_bytes(head[6:8], "little")
        key = self._lengths if node_type == 0 else 8 + 8 * (rank + 1)
        c = self._cursor(addr + len(head), (used + 1) * key + used * self._offsets)
        keys, children = [], []
        for _ in range(used):
            keys.append(c.take(key))
            children.append(c.addr())
        for k, child in zip(keys, children):
            if level > 0:
                yield from self._btree_children(child, node_type, rank, level - 1)
            elif node_type == 0:
                yield child
            else:
                size, mask = struct.unpack_from("<II", k)
                offsets = struct.unpack_from(f"<{rank}Q", k, 8)
                yield offsets, size, mask, child

    def _symbol_node(self, addr):
        head = self._read(addr, 8)
        if head[:4] != b"SNOD":
            self._damaged(f"symbol table node at {addr} without its signature")
        n = int.from_bytes(head[6:8], "little")
        entry = 2 * self._offsets + 24
        c = self._cursor(addr + 8, n * entry)
        for _ in range(n):
            name, header = c.addr(), c.addr()
            c.take(24)  # cache type, reserved, scratch pad
            yield name, header

    def _group_links(self, messages, name):
        """{link name: (kind, target)} of a group stored as link messages
        (compact) or in dense storage (the link info message's heap)."""
        for mtype, _, body in messages:
            if mtype == LINK_INFO:
                c = _Cursor(body, 2 + (8 if body[1] & 1 else 0), self._offsets, self._lengths)
                heap, names = c.addr(), c.addr()
                order = c.addr() if body[1] & 2 else None
                if not self._undefined(heap):
                    return self._dense_links(heap, names, order, name)
        return dict(self._link(body) for mtype, _, body in messages if mtype == LINK)

    def _link(self, body):
        """(name, (kind, target address or None)) of a link message."""
        flags = body[1]
        c = _Cursor(body, 2, self._offsets, self._lengths)
        kind = c.u(1) if flags & 0x08 else 0
        c.u(8 if flags & 0x04 else 0)  # the creation order
        c.u(1 if flags & 0x10 else 0)  # the name's character set
        link = c.take(c.u(1 << (flags & 3))).decode("utf-8")
        target = c.addr() if kind == 0 else None
        return link, ("hard", target) if kind == 0 else (
            "soft" if kind == 1 else "external" if kind == 64 else f"type {kind}", None)

    def _dense_links(self, heap_addr, names, order, name):
        """The links of a group in dense storage: each record of its v2
        B-tree of names (type 5: hash, heap ID) or, where that is the only
        index, of creation order (type 6: order, heap ID) points at a link
        message in the fractal heap."""
        heap = self._fractal_heap(heap_addr, f"group {name}")
        index = names if not self._undefined(names) else order
        if index is None or self._undefined(index):
            self._damaged(f"group {name}'s dense storage without an index")
        skip = {5: 4, 6: 8}
        links = {}
        for rtype, record in self._btree2_records(index, (5, 6), f"group {name}'s links"):
            link, value = self._link(heap(record[skip[rtype]:]))
            links[link] = value
        return links

    def _fractal_heap(self, addr, what):
        """The object reader of the fractal heap at `addr`: heap ID ->
        bytes, for managed objects (in the direct blocks, found under the
        root's doubling table) and tiny ones (inside the ID)."""
        O, L = self._offsets, self._lengths
        size = 4 + 1 + 2 + 2 + 1 + 4 + 12 * L + 3 * O + 2 + 2 + 2 + 2
        c = _Cursor(self._checked(addr, size, f"the fractal heap of {what}"), 0, O, L)
        if c.take(4) != b"FRHP" or c.u(1) != 0:
            self._damaged(f"fractal heap header at {addr} ({what})")
        id_len, filter_len, flags, max_managed = c.u(2), c.u(2), c.u(1), c.u(4)
        if filter_len:
            self._refuse(f"a filter on the fractal heap of {what}")
        c.length(), c.addr(), c.length(), c.addr()  # huge IDs, B-tree; free space, manager
        for _ in range(8):  # managed, allocated, iterator; managed, huge, tiny sizes and counts
            c.length()
        width, start, max_direct, max_bits, _, root, rows = (
            c.u(2), c.length(), c.length(), c.u(2), c.u(2), c.addr(), c.u(2))
        if not (width and start and max_direct) or width & (width - 1) \
                or start & (start - 1) or max_direct & (max_direct - 1) \
                or not start <= max_direct < 1 << 40 or not 0 < max_bits <= 64:
            self._damaged(f"fractal heap doubling table ({what})")
        off_size = (max_bits + 7) // 8
        len_size = min((max_direct.bit_length() - 1 + 7) // 8, _enc_size(max_managed))
        direct_rows = max_direct.bit_length() - start.bit_length() + 2
        first_row_bits = start.bit_length() - 1 + width.bit_length() - 1
        row_size = [start] + [start << r for r in range(64)]
        blocks = {}  # heap offset -> the direct block's bytes

        def direct(block, n, offset):
            data = bytearray(self._read(block, n))
            head = 4 + 1 + O + off_size
            if data[:4] != b"FHDB" or (flags & 2 and len(data) < head + 4):
                self._damaged(f"fractal heap direct block at {block} ({what})")
            if flags & 2:  # the checksum of the whole block, its own field zeroed
                stored = int.from_bytes(data[head:head + 4], "little")
                data[head:head + 4] = b"\0\0\0\0"
                if lookup3(data) != stored:
                    self._damaged(f"the checksum of the fractal heap block at {block}")
            blocks[offset] = bytes(data)

        def indirect(block, nrows, offset, depth=0):
            if depth > 8 or nrows > 64:
                self._damaged(f"fractal heap indirect block at {block} ({what})")
            n = nrows * width
            c = _Cursor(self._checked(block, 4 + 1 + O + off_size + n * O,
                                      f"the fractal heap of {what}"), 0, O, L)
            if c.take(4) != b"FHIB":
                self._damaged(f"fractal heap indirect block at {block} ({what})")
            c.take(1 + O + off_size)
            for r in range(nrows):
                for _ in range(width):
                    child = c.addr()
                    if not self._undefined(child):
                        if r < direct_rows:
                            direct(child, row_size[r], offset)
                        else:
                            indirect(child, row_size[r].bit_length() - first_row_bits, offset,
                                     depth + 1)
                    offset += row_size[r]

        if not self._undefined(root):
            if rows == 0:
                direct(root, start, 0)
            else:
                indirect(root, rows, 0)
        starts = sorted(blocks)

        def read(heap_id):
            if len(heap_id) != id_len or heap_id[0] >> 6:
                self._damaged(f"a heap ID of {len(heap_id)} bytes ({what})")
            kind = (heap_id[0] >> 4) & 3
            if kind == 2:  # tiny: the object inside the ID
                if id_len - 1 <= 16:
                    return heap_id[1:2 + (heap_id[0] & 0x0F)]
                return heap_id[2:3 + (((heap_id[0] & 0x0F) << 8) | heap_id[1])]
            if kind != 0:
                self._refuse(f"a huge fractal heap object ({what})")
            c = _Cursor(heap_id, 1, O, L)
            offset, n = c.u(off_size), c.u(len_size)
            i = bisect.bisect_right(starts, offset) - 1
            data = blocks[starts[i]] if i >= 0 else b""
            at = offset - starts[i] if i >= 0 else 0
            if i < 0 or at + n > len(data):
                self._damaged(f"heap object at offset {offset} of {n} bytes ({what})")
            return data[at:at + n]

        return read

    def _btree2_records(self, addr, types, what):
        """(record type, record bytes) of every record of the version 2
        B-tree at `addr`, in key order; its type must be one of `types`."""
        O, L = self._offsets, self._lengths
        c = _Cursor(self._checked(addr, 4 + 1 + 1 + 4 + 2 + 2 + 1 + 1 + O + 2 + L,
                                  f"the B-tree of {what}"), 0, O, L)
        if c.take(4) != b"BTHD" or c.u(1) != 0:
            self._damaged(f"v2 B-tree header at {addr} ({what})")
        rtype, node_size, rec_size, depth = c.u(1), c.u(4), c.u(2), c.u(2)
        c.u(2)  # split and merge percents
        root, root_nrec = c.addr(), c.u(2)
        if rtype not in types:
            self._refuse(f"a v2 B-tree of record type {rtype} ({what})")
        if self._undefined(root) or root_nrec == 0:
            return
        if not 10 + rec_size <= node_size < 1 << 24 or rec_size == 0 or depth > 16:
            self._damaged(f"v2 B-tree node size {node_size}, record {rec_size} ({what})")
        leaf_max = (node_size - 10) // rec_size
        nrec_size = _enc_size(leaf_max)
        cum, cum_size = [leaf_max], [0]  # records under a node of each depth, their width
        for d in range(1, depth + 1):
            pointer = O + nrec_size + cum_size[d - 1]
            most = (node_size - 10 - pointer) // (rec_size + pointer)
            cum.append((most + 1) * cum[d - 1] + most)
            cum_size.append(_enc_size(cum[d]))

        def node(at, nrec, d):
            if d == 0:
                data = self._checked(at, 6 + nrec * rec_size, f"the B-tree of {what}")
                if data[:4] != b"BTLF" or data[5] != rtype:
                    self._damaged(f"v2 B-tree leaf at {at} ({what})")
                for i in range(nrec):
                    yield rtype, data[6 + i * rec_size:6 + (i + 1) * rec_size]
                return
            pointer = O + nrec_size + cum_size[d - 1]
            data = self._checked(at, 6 + nrec * rec_size + (nrec + 1) * pointer,
                                 f"the B-tree of {what}")
            if data[:4] != b"BTIN" or data[5] != rtype:
                self._damaged(f"v2 B-tree internal node at {at} ({what})")
            c = _Cursor(data, 6 + nrec * rec_size, O, L)
            children = []
            for _ in range(nrec + 1):
                children.append((c.addr(), c.u(nrec_size)))
                c.u(cum_size[d - 1])  # the records under the child
            for i, (child, n) in enumerate(children):
                yield from node(child, n, d - 1)
                if i < nrec:
                    yield rtype, data[6 + i * rec_size:6 + (i + 1) * rec_size]

        yield from node(root, root_nrec, depth)

    # -- datasets --------------------------------------------------------------

    def _dataspace(self, body, name):
        version, rank, flags = body[0], body[1], body[2]
        if version == 2 and body[3] == 2:
            self._refuse(f"a null dataspace ({name})")
        if version not in (1, 2):
            self._refuse(f"dataspace version {version} ({name})")
        c = _Cursor(body, 8 if version == 1 else 4, self._offsets, self._lengths)
        dims = tuple(c.length() for _ in range(rank))
        maxdims = tuple(c.length() for _ in range(rank)) if flags & 1 else dims
        return dims, maxdims

    def _datatype(self, body, name):
        cls, bits = body[0] & 0x0F, int.from_bytes(body[1:4], "little")
        size = int.from_bytes(body[4:8], "little")
        order = ">" if bits & 1 else "<"
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", body, 8)
            if size not in (1, 2, 4, 8) or (offset, precision) != (0, 8 * size):
                self._refuse(f"a {precision}-bit fixed-point type at bit {offset} of {size} "
                             f"bytes ({name})")
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            layout = struct.unpack_from("<HHBBBBI", body, 8) + ((bits >> 8) & 0xFF,)
            if bits & 0x40 or size not in IEEE or layout != IEEE[size] \
                    or (bits >> 4) & 3 != 2:
                self._refuse(f"a floating-point type of {size} bytes that is not IEEE "
                             f"{layout} ({name})")
            return np.dtype(f"{order}f{size}")
        self._refuse(f"the {DATATYPE_CLASSES[cls] if cls < len(DATATYPE_CLASSES) else cls} "
                     f"datatype class ({name})")

    def _filters(self, messages, name):
        """[(filter id, client data)] of the dataset's pipeline, in the order
        they were applied on writing."""
        bodies = [m[2] for m in messages if m[0] == PIPELINE]
        if not bodies:
            return []
        body = bodies[0]
        version, n = body[0], body[1]
        c = _Cursor(body, 8 if version == 1 else 2, self._offsets, self._lengths)

        def one():
            fid = c.u(2)
            name_len = c.u(2) if version == 1 or fid >= 256 else 0
            c.u(2)  # flags
            nvals = c.u(2)
            c.take(-(-name_len // 8) * 8 if version == 1 else name_len)
            vals = [c.u(4) for _ in range(nvals)]
            c.take(4 if version == 1 and nvals % 2 else 0)
            return fid, vals

        if version not in (1, 2):
            self._refuse(f"filter pipeline version {version} ({name})")
        filters = [one() for _ in range(n)]
        for fid, _ in filters:
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
                self._refuse(f"the {FILTER_NAMES.get(fid, f'id {fid}')} filter ({name})")
        return filters

    def _fill(self, messages, dtype, name):
        """The dataset's fill value as an array of one element (zero where
        none is stored)."""
        for mtype, _, body in messages:
            if mtype == FILL:
                if body[0] in (1, 2):
                    has = body[0] == 1 or body[3] == 1
                    at = 4
                elif body[0] == 3:
                    has, at = bool(body[1] & 0x20), 2
                else:
                    self._refuse(f"fill value message version {body[0]} ({name})")
                size = int.from_bytes(body[at:at + 4], "little") if has else 0
                value = body[at + 4:at + 4 + size]
                break
            if mtype == FILL_OLD:
                size = int.from_bytes(body[:4], "little")
                value = body[4:4 + size]
                break
        else:
            size = 0
        if size == 0:
            return np.zeros(1, dtype)
        if size != dtype.itemsize or len(value) != size:
            self._damaged(f"a fill value of {size} bytes for {dtype} ({name})")
        return np.frombuffer(value, dtype).copy()

    def _empty(self, ds, nbytes):
        """An uninitialised array of the dataset's shape and dtype: where
        the file does not hold its bytes (chunks, fill values), a shape too
        large to allocate is reported with the file."""
        try:
            return np.empty(ds.shape, ds.dtype)
        except MemoryError:
            raise ValueError(f"{self.path}: {ds.name} of shape {ds.shape} ({nbytes} bytes) "
                             "cannot be allocated: a damaged dataspace, or larger than "
                             "memory") from None

    def _read_dataset(self, ds):
        name, messages = ds.name, ds._messages
        body = _one(self, messages, LAYOUT, name)
        version, cls = body[0], body[1]
        if version not in (3, 4):
            self._refuse(f"data layout version {version} ({name})")
        count, dtype = math.prod(ds.shape), ds.dtype
        nbytes = count * dtype.itemsize
        c = _Cursor(body, 2, self._offsets, self._lengths)
        if cls == 0:  # compact: the data inside the message
            size = c.u(2)
            if size < nbytes:
                self._damaged(f"compact data of {size} bytes for {nbytes} ({name})")
            return np.frombuffer(c.take(nbytes), dtype).reshape(ds.shape).copy()
        if cls == 1:
            addr, size = c.addr(), c.length()
            if self._undefined(addr):  # never written
                out = self._empty(ds, count * dtype.itemsize)
                out[...] = self._fill(messages, dtype, name)[0]
                return out
            if size < nbytes or self._base + addr + nbytes > self._size:
                self._damaged(f"contiguous data of {size} bytes at {addr} for {nbytes} ({name})")
            out = np.empty(ds.shape, dtype)
            self._f.seek(self._base + addr)
            if nbytes and self._f.readinto(out.reshape(-1).view(np.uint8)) != nbytes:
                self._damaged(f"short read of the contiguous data at {addr} ({name})")
            return out
        if cls == 2:
            return self._read_chunked(ds, body, c, messages)
        self._refuse(f"the {'virtual' if cls == 3 else f'class {cls}'} data layout ({name})")

    def _read_chunked(self, ds, body, c, messages):
        name, dtype, shape = ds.name, ds.dtype, ds.shape
        rank = len(shape)
        if body[0] == 3:  # a version 1 B-tree
            c.pos = 3
            index = ("btree", c.addr())
            chunk = [c.u(4) for _ in range(body[2])]
        else:
            flags, width = body[2], body[4]
            c.pos = 5
            chunk = [c.u(width) for _ in range(body[3])]
            kind = c.u(1)
            if kind == 1:  # a single chunk, its filtered size stored if filtered
                size, mask = (c.length(), c.u(4)) if flags & 2 else (None, 0)
                index = ("single", c.addr(), size, mask)
            elif kind in (2, 3):  # implicit; a fixed array (after its page bits)
                c.u(1 if kind == 3 else 0)
                index = ("implicit" if kind == 2 else "fixed", c.addr())
            elif kind in (4, 5):  # an extensible array; a v2 B-tree (after their parameters)
                c.take(5 if kind == 4 else 6)
                index = ("earray" if kind == 4 else "btree2", c.addr())
            else:
                self._refuse(f"chunk index type {kind} ({name})")
        if len(chunk) != rank + 1 or chunk[-1] != dtype.itemsize:
            self._damaged(f"chunk dims {chunk} for shape {shape}, {dtype} ({name})")
        chunk = tuple(chunk[:-1])
        filters = self._filters(messages, name)
        if body[0] == 4 and flags & 1 and filters:
            self._refuse(f"partial edge chunks stored unfiltered ({name})")
        out = self._empty(ds, math.prod(shape) * dtype.itemsize)
        out[...] = self._fill(messages, dtype, name)[0]
        chunk_bytes = math.prod(chunk) * dtype.itemsize
        for offsets, size, mask, addr in self._chunks(index, ds._maxshape, chunk, chunk_bytes):
            if self._undefined(addr) or any(o >= s for o, s in zip(offsets, shape)):
                continue
            raw = self._unfilter(self._read(addr, size), filters, mask, name)
            if len(raw) != chunk_bytes:
                self._damaged(f"a chunk of {len(raw)} bytes for {chunk_bytes} ({name})")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            cut = tuple(slice(0, min(k, s - o)) for o, k, s in zip(offsets, chunk, shape))
            out[tuple(slice(o, o + s.stop) for o, s in zip(offsets, cut))] = block[cut]
        return out

    def _chunks(self, index, maxshape, chunk, chunk_bytes):
        """(offsets, stored size, filter mask, address) of every chunk."""
        kind, rank = index[0], len(chunk)
        if self._undefined(index[1]):  # no chunk written yet
            return
        if kind == "btree":
            for offsets, size, mask, addr in self._btree_children(index[1], 1, rank):
                yield offsets[:rank], size, mask, addr
            return
        if kind == "btree2":  # records: address, [stored size, filter mask,] scaled offsets
            O = self._offsets
            for rtype, rec in self._btree2_records(index[1], (10, 11), "a chunk index"):
                width = len(rec) - O - 8 * rank - (4 if rtype == 11 else 0)
                c = _Cursor(rec, 0, O, self._lengths)
                addr = c.addr()
                size, mask = (c.u(width), c.u(4)) if rtype == 11 else (chunk_bytes, 0)
                yield tuple(c.u(8) * k for k in chunk), size, mask, addr
            return

        # a linear index's chunk: row-major over the grid of chunks, an
        # extensible array's unlimited dimension the slowest
        grid = [-(-m // k) for m, k in zip(maxshape, chunk)]
        unlimited = [d for d, m in enumerate(maxshape) if m == (1 << (8 * self._lengths)) - 1]
        if len(unlimited) != (kind == "earray"):
            self._damaged(f"a {kind} chunk index over {len(unlimited)} unlimited dimensions")
        steps, step = [0] * rank, 1
        for d in reversed(unlimited + [d for d in range(rank) if d not in unlimited]):
            steps[d], step = step, step * grid[d]

        def offsets_of(i):
            return tuple(i // steps[d] % grid[d] * chunk[d] for d in range(rank))

        if kind == "single":
            _, addr, size, mask = index
            yield (0,) * rank, chunk_bytes if size is None else size, mask, addr
        elif kind == "implicit":
            for i in range(math.prod(grid)):
                yield offsets_of(i), chunk_bytes, 0, index[1] + i * chunk_bytes
        else:
            entries = self._fixed_array if kind == "fixed" else self._extensible_array
            for i, addr, size, mask in entries(index[1]):
                yield offsets_of(i), chunk_bytes if size is None else size, mask, addr

    def _fixed_array(self, addr):
        """(index, address, stored size or None, filter mask) of each entry
        of the fixed array at `addr` (pages never written have none)."""
        c = _Cursor(self._checked(addr, 8 + self._lengths + self._offsets, "a fixed array"), 0,
                    self._offsets, self._lengths)
        if c.take(4) != b"FAHD":
            self._damaged(f"fixed array header at {addr} without its signature")
        c.u(1)
        client, entry, page_bits = c.u(1), c.u(1), c.u(1)
        n, block = c.length(), c.addr()
        page = 1 << page_bits
        pages = -(-n // page) if n > page else 0
        init = -(-pages // 8)  # a bit a page, the first the high bit of byte 0
        prefix = 6 + self._offsets + init
        head = self._checked(block, prefix + (0 if pages else n * entry), "a fixed array")
        if head[:4] != b"FADB":
            self._damaged(f"fixed array data block at {block} without its signature")
        if not pages:  # the entries inside the block
            spans = [(head[prefix:], 0, n)]
        else:  # pages after the block, each with its checksum
            bitmap = head[6 + self._offsets:]
            spans = [(self._checked(block + prefix + 4 + p * (page * entry + 4),
                                    min(page, n - p * page) * entry, "a fixed array page"),
                      p * page, min(page, n - p * page))
                     for p in range(pages) if bitmap[p // 8] & (0x80 >> (p % 8))]
        for data, first, count in spans:
            c = _Cursor(data, 0, self._offsets, self._lengths)
            for _ in range(count):
                if client == 0:
                    yield first, c.addr(), None, 0
                else:
                    yield first, c.addr(), c.u(entry - self._offsets - 4), c.u(4)
                first += 1

    def _extensible_array(self, addr):
        """(index, address, stored size or None, filter mask) of each entry
        of the extensible array at `addr`: the index block's own elements,
        then the data blocks of each super block in turn (those of the first
        few listed in the index block, the rest in super blocks), the pages
        of a paged data block where its bit in the super block's bitmap is
        set."""
        O, L = self._offsets, self._lengths
        c = _Cursor(self._checked(addr, 12 + 6 * L + O, "an extensible array"), 0, O, L)
        if c.take(4) != b"EAHD" or c.u(1) != 0:
            self._damaged(f"extensible array header at {addr} without its signature")
        client, entry, max_bits, idx_elements, min_elements, min_pointers, page_bits = (
            c.u(1) for _ in range(7))
        for _ in range(4):  # super and data blocks: counts and sizes
            c.length()
        max_index, _, iblock = c.length(), c.length(), c.addr()
        if self._undefined(iblock):
            return
        if not (0 < max_bits <= 64 and min_elements and min_pointers and page_bits < 32
                and not min_elements & (min_elements - 1) and not min_pointers & (min_pointers - 1)
                and entry >= O + (5 if client else 0)):
            self._damaged(f"extensible array parameters at {addr}")
        off_size, page = (max_bits + 7) // 8, 1 << page_bits
        # super block u: 2^(u // 2) data blocks of 2^((u + 1) // 2) * min_elements
        n_super = 1 + max_bits - (min_elements.bit_length() - 1)
        blocks = [(1 << (u // 2), (1 << ((u + 1) // 2)) * min_elements) for u in range(n_super)]
        in_index = 2 * (min_pointers.bit_length() - 1)  # super blocks listed in the index block
        n_data = 2 * (min_pointers - 1)
        data = self._checked(iblock, 6 + O + idx_elements * entry + (n_data + n_super - in_index)
                             * O, "an extensible array index block")
        if data[:4] != b"EAIB":
            self._damaged(f"extensible array index block at {iblock} without its signature")
        c = _Cursor(data, 6 + O, O, L)

        def elements(c, first, count):
            for i in range(first, first + count):
                if client == 0:
                    yield i, c.addr(), None, 0
                else:
                    yield i, c.addr(), c.u(entry - O - 4), c.u(4)

        yield from elements(c, 0, idx_elements)
        data_blocks = [c.addr() for _ in range(n_data)]
        supers = [c.addr() for _ in range(n_super - in_index)]
        first = idx_elements
        for u, (count, n) in enumerate(blocks):
            if first >= max_index:
                return
            if u < in_index:
                addrs, bitmap = data_blocks[:count], None
                data_blocks = data_blocks[count:]
            else:
                sblock = supers[u - in_index]
                if self._undefined(sblock):
                    first += count * n
                    continue
                pages = n // page if n > page else 0
                bitmap_size = count * (-(-pages // 8)) if pages else 0
                head = 6 + O + off_size
                data = self._checked(sblock, head + bitmap_size + count * O,
                                     "an extensible array super block")
                if data[:4] != b"EASB":
                    self._damaged(f"extensible array super block at {sblock} without its "
                                  "signature")
                bitmap = data[head:head + bitmap_size] if pages else None
                c = _Cursor(data, head + bitmap_size, O, L)
                addrs = [c.addr() for _ in range(count)]
            for j, block in enumerate(addrs):
                if not self._undefined(block):
                    yield from self._ea_data_block(block, first, n, entry, off_size, page,
                                                   bitmap, j, elements)
                first += n

    def _ea_data_block(self, block, first, n, entry, off_size, page, bitmap, j, elements):
        """The entries of one extensible array data block of n elements,
        the j-th of its super block (whose page bitmap, if paged, is
        `bitmap`: a bit a page, block by block, the first the high bit)."""
        O, L = self._offsets, self._lengths
        head = 6 + O + off_size
        if bitmap is None:
            data = self._checked(block, head + n * entry, "an extensible array data block")
            if data[:4] != b"EADB":
                self._damaged(f"extensible array data block at {block} without its signature")
            yield from elements(_Cursor(data, head, O, L), first, n)
            return
        if self._checked(block, head, "an extensible array data block")[:4] != b"EADB":
            self._damaged(f"extensible array data block at {block} without its signature")
        pages = n // page
        for p in range(pages):
            bit = j * pages + p
            if bitmap[bit // 8] & (0x80 >> (bit % 8)):
                data = self._checked(block + head + 4 + p * (page * entry + 4), page * entry,
                                     "an extensible array data block page")
                yield from elements(_Cursor(data, 0, O, L), first + p * page, page)

    def _unfilter(self, raw, filters, mask, name):
        for i in reversed(range(len(filters))):
            if mask & (1 << i):
                continue
            fid, vals = filters[i]
            if fid == DEFLATE:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    self._damaged(f"a deflated chunk that does not inflate: {e} ({name})")
            elif fid == SHUFFLE:
                raw = _unshuffle(raw, vals[0] if vals else 1)
            else:
                if len(raw) < 4:
                    self._damaged(f"a fletcher32 chunk of {len(raw)} bytes ({name})")
                raw, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
                sum_ = fletcher32(raw)
                # HDF5 before 1.6.3 stored it with each 16-bit half's bytes swapped
                swapped = ((sum_ & 0x00FF00FF) << 8) | ((sum_ >> 8) & 0x00FF00FF)
                if stored not in (sum_, swapped):
                    self._damaged(f"a fletcher32 checksum mismatch ({name})")
        return raw


def lookup3(data):
    """Bob Jenkins' lookup3 hash of `data` (hashlittle, initial value 0):
    the checksum of HDF5's version 2 metadata."""
    mask = 0xFFFFFFFF

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & mask

    n = len(data)
    a = b = c = (0xDEADBEEF + n) & mask
    if n == 0:
        return c
    tail = -(-n // 12) * 12
    words = struct.unpack(f"<{tail // 4}I", bytes(data) + b"\0" * (tail - n))
    for i in range(0, len(words) - 3, 3):  # every 12 bytes but the last
        a, b, c = (a + words[i]) & mask, (b + words[i + 1]) & mask, (c + words[i + 2]) & mask
        a = ((a - c) & mask) ^ rot(c, 4)
        c = (c + b) & mask
        b = ((b - a) & mask) ^ rot(a, 6)
        a = (a + c) & mask
        c = ((c - b) & mask) ^ rot(b, 8)
        b = (b + a) & mask
        a = ((a - c) & mask) ^ rot(c, 16)
        c = (c + b) & mask
        b = ((b - a) & mask) ^ rot(a, 19)
        a = (a + c) & mask
        c = ((c - b) & mask) ^ rot(b, 4)
        b = (b + a) & mask
    a, b, c = (a + words[-3]) & mask, (b + words[-2]) & mask, (c + words[-1]) & mask
    c = ((c ^ b) - rot(b, 14)) & mask
    a = ((a ^ c) - rot(c, 11)) & mask
    b = ((b ^ a) - rot(a, 25)) & mask
    c = ((c ^ b) - rot(b, 16)) & mask
    a = ((a ^ c) - rot(c, 4)) & mask
    b = ((b ^ a) - rot(a, 14)) & mask
    c = ((c ^ b) - rot(b, 24)) & mask
    return c


def _enc_size(n):
    """The bytes that the library's variable-width fields give a count
    of up to n (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _unshuffle(raw, size):
    n = len(raw) // size
    if size <= 1 or n == 0:
        return raw
    planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return planes.T.tobytes() + raw[n * size:]


def fletcher32(data):
    """HDF5's Fletcher-32 of `data`: big-endian 16-bit words (a last odd
    byte as the high byte of one); sum1 adds the words and sum2 the running
    sum1, both modulo 65535 with 0xffff standing for a positive multiple
    (the library folds its sums so)."""
    data = bytes(data)
    words = np.frombuffer(data[:len(data) // 2 * 2], ">u2").astype(np.int64)
    if len(data) % 2:
        words = np.append(words, data[-1] << 8)
    weights = np.arange(len(words), 0, -1, dtype=np.int64) % 65535  # word i is in n - i sums
    s1, s2 = int(words.sum()) % 65535, int(np.sum(words * weights)) % 65535
    if words.any():
        s1, s2 = s1 or 0xFFFF, s2 or 0xFFFF
    return (s2 << 16) | s1


# -- the writer ------------------------------------------------------------------

OFFSETS = LENGTHS = 8
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16  # the library's defaults: 8 links a node, 32 nodes
UNDEFINED = (1 << 64) - 1
ENTRY = 2 * OFFSETS + 24  # a symbol table entry


def _pad8(data):
    return bytes(data) + b"\0" * (-len(data) % 8)


def _header_v1(messages):
    """A version 1 object header holding `messages` [(type, data)], the
    datatype and fill value marked constant as the library marks them."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), 1 if t in (DATATYPE, FILL) else 0)
                    + _pad8(d) for t, d in messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def dataspace_message(shape):
    """A version 1 simple dataspace, its maximum dims the dims."""
    return struct.pack("<BBB5x", 1, len(shape), 1) + struct.pack(f"<{2 * len(shape)}Q", *shape,
                                                                  *shape)


def datatype_message(dtype):
    """The datatype message of a numpy integer or IEEE float dtype."""
    dtype = np.dtype(dtype)
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian) \
        else 0
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return struct.pack("<B3BIHH", 0x10, order | (0x08 if dtype.kind == "i" else 0), 0, 0,
                           dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in IEEE:
        offset, precision, eloc, esize, mloc, msize, bias, sign = IEEE[dtype.itemsize]
        return struct.pack("<B3BIHHBBBBI", 0x11, order | 0x20, sign, 0, dtype.itemsize, offset,
                           precision, eloc, esize, mloc, msize, bias)
    raise ValueError(f"hpcs_torch.utils.hdf5 writes integer and IEEE float arrays, not {dtype}")


# the fill value message h5py writes by default: version 2, allocation
# late, fill written if set, the default fill value (size 0: zeros)
FILL_DEFAULT = struct.pack("<BBBBI", 2, 2, 2, 1, 0)


class _Image:
    """A file image built front to back: `alloc` places a zeroed block at
    the next 8-byte boundary, `put` fills it."""

    def __init__(self):
        self.buf = bytearray()

    def alloc(self, n):
        self.buf += b"\0" * (-len(self.buf) % 8)
        addr = len(self.buf)
        self.buf += b"\0" * n
        return addr

    def put(self, addr, data):
        self.buf[addr:addr + len(data)] = data


def contiguous_messages(image, array):
    """The messages of `array` stored contiguously in `image`."""
    addr = image.alloc(array.nbytes) if array.nbytes else UNDEFINED
    if array.nbytes:
        image.put(addr, np.ascontiguousarray(array).tobytes())
    return [(DATASPACE, dataspace_message(array.shape)), (DATATYPE, datatype_message(array.dtype)),
            (FILL, FILL_DEFAULT), (LAYOUT, struct.pack("<BBQQ", 3, 1, addr, array.nbytes))]


def write_h5(path, arrays, messages=contiguous_messages):
    """Write `arrays` ({name: numpy array}) as the root group's datasets of
    a new HDF5 file at `path` (superblock version 0, a symbol table; each
    dataset `messages(image, array)`, contiguous by default)."""
    names = sorted(arrays)
    for name in names:
        if not name or "/" in name or "\0" in name or name == ".":
            raise ValueError(f"{path}: {name!r} is not a dataset name")
    per_node = 2 * GROUP_LEAF_K
    nodes = [names[i:i + per_node] for i in range(0, len(names), per_node)] or [[]]
    if len(nodes) > 2 * GROUP_INTERNAL_K:
        raise ValueError(f"{path}: {len(names)} datasets; hpcs_torch.utils.hdf5 writes up to "
                         f"{2 * GROUP_INTERNAL_K * per_node}")
    heap, offsets = bytearray(8), {}  # offset 0: the empty name
    for name in names:
        offsets[name] = len(heap)
        heap += _pad8(name.encode("utf-8") + b"\0")

    image = _Image()
    superblock = image.alloc(8 + 16 + 4 * OFFSETS + ENTRY)
    btree_size = 8 + 2 * OFFSETS + (2 * GROUP_INTERNAL_K + 1) * LENGTHS \
        + 2 * GROUP_INTERNAL_K * OFFSETS
    btree = image.alloc(btree_size)
    snods = [image.alloc(8 + per_node * ENTRY) for _ in nodes]
    heap_header = image.alloc(8 + 2 * LENGTHS + OFFSETS)
    heap_data = image.alloc(len(heap))
    stab = struct.pack("<QQ", btree, heap_header)
    root_header = _header_v1([(SYMBOL_TABLE, stab)])
    root = image.alloc(len(root_header))
    image.put(root, root_header)

    headers = {}
    for name in names:
        header = _header_v1(messages(image, np.asarray(arrays[name])))
        headers[name] = image.alloc(len(header))
        image.put(headers[name], header)

    image.put(heap_data, heap)
    # the free list's head: 1, the library's mark for no free block
    image.put(heap_header, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
    keys = [0] + [offsets[node[-1]] if node else 0 for node in nodes]
    tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(nodes), UNDEFINED, UNDEFINED)
    for i, snod in enumerate(snods):
        tree += struct.pack("<QQ", keys[i], snod)
    image.put(btree, tree + struct.pack("<Q", keys[-1]))
    for node, snod in zip(nodes, snods):
        entries = b"".join(struct.pack("<QQI4x16x", offsets[n], headers[n], 0) for n in node)
        image.put(snod, b"SNOD" + struct.pack("<BxH", 1, len(node)) + entries)
    image.put(superblock, SIGNATURE + struct.pack(
        "<BBBxBBBxHHI", 0, 0, 0, 0, OFFSETS, LENGTHS, GROUP_LEAF_K, GROUP_INTERNAL_K, 0)
        + struct.pack("<QQQQ", 0, UNDEFINED, len(image.buf), UNDEFINED)
        + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap_header))
    with open(path, "wb") as f:
        f.write(image.buf)
