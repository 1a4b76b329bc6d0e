"""Build and load the native code of ``parquet_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` (a CUDA kernel) compiles with ``nvcc`` for
``sm_90a``, and each ``csrc/<name>.cpp`` (host code: the Snappy codec and
the byte-array scans, the read path's prescan, chunk planner and staging
fill, the lookup's match and gather) with the system ``c++``,
into its own shared library with a plain C interface,
``_build/lib<name>.<hash>.so`` in the package directory, at first use;
``<hash>`` covers the source, the headers of ``csrc/`` it may include
(``.cuh`` for a kernel, ``.h`` for host code) and the flags, so an edited
source or header rebuilds.  The libraries load with ``ctypes``.
:func:`build_all` starts one compiler per source at once.  A failed build
raises: there is no fallback.

One compile per library across processes: the check for the library and
its build run under an ``fcntl.flock`` on ``_build/.<name>.lock``, so the
first process compiles and the others wait, then load the same file (the
test workers of one session all start cold).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-I", CSRC]
BUILD_TIMEOUT_S = 600

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
    "host_codec": {
        "pq_snappy_max_compressed_length": (_LL, [_LL]),
        "pq_snappy_compress": (_LL, [_P, _LL, _P]),
        "pq_snappy_uncompress": (_I, [_P, _LL, _P, _LL]),
        "pq_plain_ba_batch": (_LL, [_P, _P, _P, _LL, _P, _P]),
        "pq_encode_rle": (_LL, [_P, _LL, _I, _LL, _P]),
        "pq_encode_plain_ba": (None, [_P, _P, _LL, _P]),
        "pq_minmax_ba": (None, [_P, _P, _LL, _LL, _P, _P]),
        "pq_dict_build_ba": (_LL, [_P, _P, _LL, _LL, _P, _P]),
        "pq_dict_build_i64": (_LL, [_P, _LL, _LL, _P, _P]),
        "pq_common_prefix_lens": (None, [_P, _P, _LL, _P]),
    },
    "host_prescan": {
        "pq_scan_rle_runs": (_LL, [_P, _LL, _LL, _LL, _P, _P, _P, _P, _P]),
        "pq_count_target_in_runs": (_LL, [_P, _LL, _P, _P, _P, _P, _LL, _LL,
                                          _LL]),
        "pq_delta_prescan": (_LL, [_P, _LL, _LL, _LL, _P, _P, _P, _P]),
        "pq_delta_decode": (_LL, [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _LL,
                                  _P]),
        "pq_scan_page_headers": (_LL, [_P, _LL, _LL, _LL, _P, _LL, _P]),
        "pq_zstd_available": (_LL, []),
        "pq_decompress_pages": (_LL, [_P, _P, _LL, _LL, _P, _P, _LL]),
        "pq_chunk_plan": (_P, [_P, _P, _LL, _LL, _LL, _LL, _LL, _P, _LL,
                               _LL, _P]),
        "pq_plan_export": (_LL, [_P, _P, _LL]),
        "pq_plan_free": (None, [_P]),
        "pq_fill_batch": (_LL, [_P, _LL, _P, _LL, _P, _LL, _LL]),
        "pq_byte_array_parts": (_LL, [_P, _LL, _P, _P, _P]),
        "pq_gather_ba": (_LL, [_P, _LL, _P, _LL, _P, _LL, _P, _P, _LL]),
        "pq_xxh64_batch": (_LL, [_P, _LL, _P, _LL, _P]),
    },
    "host_lookup": {
        "pq_lookup_match": (_LL, [_I, _P, _LL, _P, _P, _P, _P, _LL, _P, _P,
                                  _LL, _P, _P, _P, _P, _LL, _P, _P, _P, _P,
                                  _P, _P, _LL, _LL, _P, _P, _LL]),
        "pq_lookup_gather": (_LL, [_P, _P, _P, _P, _LL, _LL, _P, _LL, _P, _P,
                                   _P]),
        "pq_lookup_gather_ba": (_LL, [_P, _P, _P, _P, _P, _P, _LL, _P, _LL,
                                      _P, _P, _P, _P]),
    },
}
# csrc/<name>.cpp, built with c++
HOST_SOURCES = ("host_codec", "host_prescan", "host_lookup")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 # ptlint: disable=PT002 -- the CUDA toolkit's location,
                 # the toolchain's own variable, not a knob of the port
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of parquet_tpu_torch cannot be built")


def cxx_path() -> str:
    # ptlint: disable=PT002 -- the C++ compiler the toolchain's $CXX
    # names, not a knob of the port
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): the host "
                       "code of parquet_tpu_torch cannot be built")


def _source(name: str) -> str:
    return f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu"


def _command(name: str, out: str) -> List[str]:
    src = os.path.join(CSRC, _source(name))
    if name in HOST_SOURCES:
        return [cxx_path(), *CXX_FLAGS, "-o", out, src]
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, src]


def lib_path(name: str) -> str:
    host = name in HOST_SOURCES
    digest = hashlib.sha256(" ".join(CXX_FLAGS if host
                                     else NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC)
                     if f.endswith(".h" if host else ".cuh"))
    for src in [_source(name)] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:12]}.so")


@contextlib.contextmanager
def _file_lock(name: str):
    """Hold ``_build/.<name>.lock`` exclusively (blocks while another
    process builds ``name``)."""
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start(name: str):
    """Start the compiler for one source into a temporary file; None if
    built.  The caller holds the source's file lock."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = _command(name, tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    try:
        log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"timed out building {_source(name)}")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"the compiler failed building {_source(name)} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names: List[str] = None) -> List[str]:
    """Build every library that is missing (the kernels and the host code),
    one compiler per source, all started together, under the sources' file
    locks (taken in name order, so two processes never wait on each other
    in a cycle).  Returns the names this call compiled."""
    names = sorted(SIGNATURES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    errors = []
    with contextlib.ExitStack() as locks:
        for n in names:
            locks.enter_context(_file_lock(n))
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [n for n, s in started.items() if s is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed.  Any failure raises ``RuntimeError`` (an ``OSError`` of the
    compiler or the loader too, so that no caller takes it for an I/O
    error of the data).  Threads of one process need no lock of their own
    here: each opens the file lock anew, so ``flock`` serializes their
    builds as it does other processes', and two that race load one file
    (the loader hands both the same handle; the first kept wins)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    try:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
    except OSError as e:  # a compiler that will not start, a bad .so
        raise RuntimeError(f"cannot build or load {_source(name)}: "
                           f"{e}") from e
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return _libs.setdefault(name, lib)
