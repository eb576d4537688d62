"""ctypes bindings of the whitespace-table parser `csrc/fast_txt.cpp`.

ShapeNet-Part's clouds are text tables; numpy.loadtxt reads them tens of
times slower than the C++ parser.  At first use the source is compiled with
g++ into `hpcs_torch/_build/libfast_txt-<hash>.so` (the hash covers the
source and the flags, so an edited source is rebuilt); without a compiler
`loadtxt` falls back to numpy.loadtxt, and `available()` says which parser
runs.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "fast_txt.cpp"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _library_path():
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfast_txt-{digest}.so"


def _build(lib):
    # compile to a per-process temporary name, then rename: another process
    # sharing the checkout never sees a half-written library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([shutil.which("g++") or "g++", *FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load():
    """The parser's library, built at first use; None when it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.parse_float_table.restype = ctypes.c_long
        lib.parse_float_table.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_long, ctypes.c_long]
        lib.count_rows.restype = ctypes.c_long
        lib.count_rows.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def available():
    """True when the C++ parser runs, False when loadtxt uses numpy."""
    return _load() is not None


def loadtxt(path, n_cols=7):
    """Parse a whitespace-separated float table into float32 [rows, n_cols].

    Equal to numpy.loadtxt on well-formed tables (blank lines skipped, a
    trailing newline allowed).  Raises FileNotFoundError on a missing file.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = _load()
    if lib is None:
        return np.loadtxt(path).astype(np.float32).reshape(-1, n_cols)
    bpath = os.fspath(path).encode()
    max_rows = lib.count_rows(bpath)
    if max_rows < 0:
        raise OSError(f"cannot read {path}")
    out = np.empty((max_rows, n_cols), dtype=np.float32)
    got = lib.parse_float_table(bpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                max_rows, n_cols)
    if got < 0:
        raise OSError(f"cannot read {path}")
    return out[:got]
