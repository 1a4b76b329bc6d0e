"""Build and load the hand-written CUDA kernels of ``parquet_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``_build/lib<name>.<hash>.so`` in
the package directory, at first use; ``<hash>`` covers the source, the
headers of ``csrc/`` it may include and the flags, so an edited source or
header rebuilds.  The libraries load with ``ctypes``.
:func:`build_all` starts one ``nvcc`` per source at once.  A failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-I", CSRC]
NVCC_TIMEOUT_S = 600

# C entry points of each source: name -> (restype, argtypes)
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "unpack_bits": {
        "pq_unpack_bits_dense": (_I, [_P, _LL, _P, _LL, _I, _P]),
    },
    "dict_unpack_gather": {
        "pq_dict_unpack_gather": (_I, [_P, _LL, _P, _I, _I, _P, _LL, _I,
                                       _P]),
    },
    "bloom_check": {
        "pq_bloom_check": (_I, [_P, _LL, _P, _P, _LL, _P]),
        "pq_bloom_check_segments": (_I, [_P, _P, _I, _P, _P, _LL, _P]),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of parquet_tpu_torch cannot be built")


def lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    try:
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}.cu")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names: List[str] = None) -> None:
    """Build every kernel library that is missing, one nvcc per source, all
    started together."""
    names = list(SIGNATURES) if names is None else names
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _libs[name] = lib
        return lib
