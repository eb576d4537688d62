"""zstd frames through libzstd, with ctypes.

The JAX package's multi-process checkpoints (`utils/orbax_dir.py`) carry
zstd twice: on every OCDBT file's body and on every zarr chunk.  Python
has no zstd module and the port needs no package for it: the C library
`libzstd.so.1`, which every Linux distribution ships, is loaded at the
first call.  When it cannot be loaded, `ZstdError` says so, naming it.

- `decompress(data)`: the concatenated content of the frames in `data`.
  A frame that states its content size is decoded in one
  `ZSTD_decompress` call; one that does not (tensorstore writes its OCDBT
  nodes through the streaming API) through `ZSTD_decompressStream`.
- `compress(data, level)`: one frame that states its content size.

Errors carry `ZSTD_getErrorName`'s text.
"""
import ctypes

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"


class ZstdError(RuntimeError):
    pass


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer: {src, size, pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_SIGNATURES = {
    "ZSTD_isError": (ctypes.c_uint, [ctypes.c_size_t]),
    "ZSTD_getErrorName": (ctypes.c_char_p, [ctypes.c_size_t]),
    "ZSTD_getFrameContentSize": (ctypes.c_ulonglong, [ctypes.c_void_p, ctypes.c_size_t]),
    "ZSTD_findFrameCompressedSize": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_size_t]),
    "ZSTD_decompress": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_size_t,
                                          ctypes.c_void_p, ctypes.c_size_t]),
    "ZSTD_compressBound": (ctypes.c_size_t, [ctypes.c_size_t]),
    "ZSTD_compress": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t, ctypes.c_int]),
    "ZSTD_createDStream": (ctypes.c_void_p, []),
    "ZSTD_freeDStream": (ctypes.c_size_t, [ctypes.c_void_p]),
    "ZSTD_initDStream": (ctypes.c_size_t, [ctypes.c_void_p]),
    "ZSTD_DStreamOutSize": (ctypes.c_size_t, []),
    "ZSTD_decompressStream": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.POINTER(_Buffer),
                                                ctypes.POINTER(_Buffer)]),
}
_lib = None


def library():
    """libzstd through ctypes, loaded once; ZstdError naming the library
    when it cannot be loaded."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise ZstdError(f"cannot load {LIBRARY} (zstd's C library), which reading the JAX "
                            f"package's orbax checkpoints needs: {e}") from e
        for fn, (restype, argtypes) in _SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _lib = lib
    return _lib


def _check(lib, code, what):
    if lib.ZSTD_isError(code):
        raise ZstdError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _stream(lib, frame):
    """The content of one frame through the streaming API."""
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise ZstdError("ZSTD_createDStream returned NULL")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "ZSTD_initDStream")
        src = ctypes.create_string_buffer(frame, len(frame))
        step = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(step)
        inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
        out, left = [], 1
        while left:
            outb = _Buffer(ctypes.cast(dst, ctypes.c_void_p), step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(ds, outb, inb), "ZSTD_decompressStream")
            out.append(dst.raw[:outb.pos])
            if left and inb.pos == inb.size and outb.pos < step:
                raise ZstdError("ZSTD_decompressStream: truncated frame")
        return b"".join(out)
    finally:
        lib.ZSTD_freeDStream(ds)


def decompress(data):
    """The content of the zstd frames in `data` (bytes-like), concatenated."""
    lib = library()
    data = bytes(data)
    out, pos = [], 0
    while pos < len(data):
        if data[pos:pos + 4] != _FRAME_MAGIC:
            raise ZstdError(f"no zstd frame at byte {pos}: {data[pos:pos + 4].hex()}")
        view = data[pos:]
        size = _check(lib, lib.ZSTD_findFrameCompressedSize(view, len(view)),
                      "ZSTD_findFrameCompressedSize")
        frame = view[:size]
        n = lib.ZSTD_getFrameContentSize(frame, size)
        if n == _CONTENTSIZE_ERROR:
            raise ZstdError(f"ZSTD_getFrameContentSize: not a valid frame at byte {pos}")
        if n == _CONTENTSIZE_UNKNOWN:
            out.append(_stream(lib, frame))
        else:
            dst = ctypes.create_string_buffer(max(n, 1))
            got = _check(lib, lib.ZSTD_decompress(dst, n, frame, size), "ZSTD_decompress")
            if got != n:
                raise ZstdError(f"ZSTD_decompress gave {got} bytes, the frame states {n}")
            out.append(dst.raw[:n])
        pos += size
    return b"".join(out)


def compress(data, level=1):
    """One zstd frame holding `data` (bytes-like), at `level`."""
    lib = library()
    data = bytes(data)
    bound = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = _check(lib, lib.ZSTD_compress(dst, bound, data, len(data), int(level)), "ZSTD_compress")
    return dst.raw[:n]
