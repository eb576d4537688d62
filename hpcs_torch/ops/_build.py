"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C entry points.  At first use it is
compiled for Hopper (sm_90a) into `hpcs_torch/_build/lib<name>-<hash>.so`,
where the hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  `build()` starts one nvcc
per source at once and waits for all of them.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("knn", "edgeconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _library_path(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_log(name):
    """nvcc's output for the last build of `name` (ptxas register counts)."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def _build_locked(names):
    jobs = []
    for name in names:
        src, lib = _library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        with open(BUILD_DIR / f"{name}.log", "w") as log:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        if proc.wait() == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}:\n{build_log(name)}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build(names=SOURCES):
    """Compile the named sources that are not built yet, all in parallel."""
    with _lock:
        _build_locked(names)


def function(name, symbol, argtypes):
    """The C entry point `symbol` of `csrc/<name>.cu`, built at first use.

    Every entry point returns the cudaError_t of its launch as an int.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(str(_library_path(name)[1]))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t):
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
