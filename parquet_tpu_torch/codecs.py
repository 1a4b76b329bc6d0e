"""Compression codecs: UNCOMPRESSED, GZIP, SNAPPY, ZSTD, LZ4_RAW, LZ4
(Hadoop framing) and BROTLI.

The port's copy of ``parquet_tpu/codecs/__init__.py``.  GZIP is the
stdlib's ``zlib``; SNAPPY is the port's own C++ (``csrc/host_codec.cpp``,
both directions), so no system Snappy library is needed;
ZSTD, LZ4 and BROTLI bind the system C libraries (``libzstd``, ``liblz4``,
``libbrotlidec``/``libbrotlienc``) with ``ctypes``.  A codec whose library
is missing raises, naming it, when the codec is first used: there is no
other decoder to fall back to.  ``Codec.decode(data, uncompressed_size)``
takes any bytes-like buffer and returns a bytes-like buffer;
``Codec.encode(data)`` returns bytes.  A stream that does not decode
raises :class:`~parquet_tpu_torch.errors.CorruptedError`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading
import zlib
from typing import Dict, Optional

import numpy as np

from .errors import CorruptedError, unsupported
from .format.enums import CompressionCodec
from .ops import host


class Codec:
    codec_id: CompressionCodec

    def encode(self, data) -> bytes:
        raise NotImplementedError

    def decode(self, data, uncompressed_size: int):
        raise NotImplementedError


class UncompressedCodec(Codec):
    codec_id = CompressionCodec.UNCOMPRESSED

    def encode(self, data) -> bytes:
        return bytes(data)

    def decode(self, data, uncompressed_size: int):
        # identity, zero-copy: page payloads are read-only buffers
        return data


class GzipCodec(Codec):
    """RFC 1952 gzip framing over deflate (the parquet GZIP codec)."""

    codec_id = CompressionCodec.GZIP

    def encode(self, data) -> bytes:
        c = zlib.compressobj(6, zlib.DEFLATED, 16 + 15)
        return c.compress(bytes(data)) + c.flush()

    def decode(self, data, uncompressed_size: int) -> bytes:
        # 32+15: accept a gzip or a zlib header
        try:
            return zlib.decompress(bytes(data), 32 + 15)
        except zlib.error as e:
            raise CorruptedError(f"malformed GZIP stream: {e}") from e


class SnappyCodec(Codec):
    """The raw Snappy block format (no framing), as Parquet stores it."""

    codec_id = CompressionCodec.SNAPPY

    def encode(self, data) -> bytes:
        return host.snappy_compress(data)

    def decode(self, data, uncompressed_size: int) -> np.ndarray:
        return host.snappy_uncompress(data, uncompressed_size)


def system_library(*names: str) -> Optional[str]:
    """The first of ``names`` (sonames, e.g. ``libzstd.so.1``) that loads,
    else None."""
    for name in names:
        for cand in (name, ctypes.util.find_library(
                name.split(".so")[0].replace("lib", "", 1))):
            if not cand:
                continue
            try:
                ctypes.CDLL(cand)
            except OSError:
                continue
            return cand
    return None


#: the system libraries each codec needs (none for the port's own)
LIBRARIES = {
    CompressionCodec.ZSTD: ("libzstd.so.1", "libzstd.so"),
    CompressionCodec.LZ4_RAW: ("liblz4.so.1", "liblz4.so"),
    CompressionCodec.LZ4: ("liblz4.so.1", "liblz4.so"),
    CompressionCodec.BROTLI: ("libbrotlidec.so.1", "libbrotlidec.so"),
}


def missing_library(codec: CompressionCodec, names) -> NotImplementedError:
    """The error for ``codec`` when none of ``names`` loads."""
    return unsupported(f"the {codec.name} codec without {' or '.join(names)}",
                       "none: the codec needs its system library")


def _require(codec: CompressionCodec, names=None) -> ctypes.CDLL:
    """The loaded system library of ``codec`` (``names``: the sonames to
    try, ``LIBRARIES[codec]`` by default)."""
    names = names or LIBRARIES[codec]
    path = system_library(*names)
    if path is None:
        raise missing_library(codec, names)
    return ctypes.CDLL(path)


_P, _SZ = ctypes.c_void_p, ctypes.c_size_t


class ZstdCodec(Codec):
    """Zstandard through ``libzstd``'s one-shot calls (thread-safe: each call
    makes its own context)."""

    codec_id = CompressionCodec.ZSTD

    def __init__(self, level: int = 3):
        lib = _require(CompressionCodec.ZSTD)
        lib.ZSTD_compressBound.argtypes = [_SZ]
        lib.ZSTD_compressBound.restype = _SZ
        lib.ZSTD_compress.argtypes = [_P, _SZ, _P, _SZ, ctypes.c_int]
        lib.ZSTD_compress.restype = _SZ
        lib.ZSTD_decompress.argtypes = [_P, _SZ, _P, _SZ]
        lib.ZSTD_decompress.restype = _SZ
        lib.ZSTD_isError.argtypes = [_SZ]
        lib.ZSTD_isError.restype = ctypes.c_uint
        self._lib, self._level = lib, level

    def encode(self, data) -> bytes:
        src = host.as_u8(data)
        cap = self._lib.ZSTD_compressBound(len(src))
        out = np.empty(cap, np.uint8)
        n = self._lib.ZSTD_compress(out.ctypes.data, cap, src.ctypes.data,
                                    len(src), self._level)
        if self._lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress failed")
        return out[:n].tobytes()

    def decode(self, data, uncompressed_size: int) -> np.ndarray:
        src = host.as_u8(data)
        out = np.empty(max(uncompressed_size, 1), np.uint8)
        n = self._lib.ZSTD_decompress(out.ctypes.data, uncompressed_size,
                                      src.ctypes.data, len(src))
        if self._lib.ZSTD_isError(n) or n != uncompressed_size:
            raise CorruptedError(f"malformed ZSTD stream ({len(src)} bytes, "
                                 f"expected {uncompressed_size} out)")
        return out[:n]


class Lz4RawCodec(Codec):
    """The LZ4 block format (LZ4_RAW, the current parquet LZ4 codec)."""

    codec_id = CompressionCodec.LZ4_RAW

    def __init__(self):
        lib = _require(CompressionCodec.LZ4_RAW)
        lib.LZ4_compressBound.argtypes = [ctypes.c_int]
        lib.LZ4_compressBound.restype = ctypes.c_int
        lib.LZ4_compress_default.argtypes = [_P, _P, ctypes.c_int,
                                             ctypes.c_int]
        lib.LZ4_compress_default.restype = ctypes.c_int
        lib.LZ4_decompress_safe.argtypes = [_P, _P, ctypes.c_int,
                                            ctypes.c_int]
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        self._lib = lib

    def encode(self, data) -> bytes:
        src = host.as_u8(data)
        cap = self._lib.LZ4_compressBound(len(src))
        out = np.empty(max(cap, 1), np.uint8)
        n = self._lib.LZ4_compress_default(src.ctypes.data, out.ctypes.data,
                                           len(src), cap)
        if n <= 0:
            raise RuntimeError("LZ4_compress_default failed")
        return out[:n].tobytes()

    def decode(self, data, uncompressed_size: int) -> np.ndarray:
        src = host.as_u8(data)
        out = np.empty(max(uncompressed_size, 1), np.uint8)
        n = self._lib.LZ4_decompress_safe(src.ctypes.data, out.ctypes.data,
                                          len(src), uncompressed_size)
        if n != uncompressed_size:
            raise CorruptedError(f"malformed LZ4 block ({len(src)} bytes, "
                                 f"expected {uncompressed_size} out)")
        return out[:n]


class Lz4HadoopCodec(Codec):
    """The deprecated Hadoop-framed LZ4 (codec id LZ4): frames of [4-byte
    big-endian uncompressed length][4-byte big-endian compressed length]
    [LZ4 block].  Some writers stored bare LZ4 blocks under this id, so a
    stream that does not parse as frames decodes as one bare block."""

    codec_id = CompressionCodec.LZ4

    def __init__(self):
        self._raw = Lz4RawCodec()

    def encode(self, data) -> bytes:
        block = self._raw.encode(data)
        return struct.pack(">II", len(host.as_u8(data)), len(block)) + block

    def decode(self, data, uncompressed_size: int) -> bytes:
        src = host.as_u8(data)
        out, pos = [], 0
        try:
            got = 0
            while pos < len(src) and got < uncompressed_size:
                if len(src) - pos < 8:
                    raise ValueError("truncated frame header")
                ulen, clen = struct.unpack_from(">II", src, pos)
                if ulen > uncompressed_size - got or clen > len(src) - pos - 8:
                    raise ValueError("implausible frame")
                pos += 8
                out.append(self._raw.decode(src[pos:pos + clen], ulen))
                got += ulen
                pos += clen
            if got != uncompressed_size:
                raise ValueError("frame lengths do not add up")
        except (ValueError, CorruptedError):
            return self._raw.decode(src, uncompressed_size)
        return b"".join(o.tobytes() for o in out)


class BrotliCodec(Codec):
    codec_id = CompressionCodec.BROTLI

    def __init__(self):
        dec = _require(CompressionCodec.BROTLI)
        enc = _require(CompressionCodec.BROTLI,
                       ("libbrotlienc.so.1", "libbrotlienc.so"))
        dec.BrotliDecoderDecompress.argtypes = [
            _SZ, _P, ctypes.POINTER(_SZ), _P]
        dec.BrotliDecoderDecompress.restype = ctypes.c_int
        enc.BrotliEncoderMaxCompressedSize.argtypes = [_SZ]
        enc.BrotliEncoderMaxCompressedSize.restype = _SZ
        enc.BrotliEncoderCompress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _SZ, _P,
            ctypes.POINTER(_SZ), _P]
        enc.BrotliEncoderCompress.restype = ctypes.c_int
        self._dec, self._enc = dec, enc

    def encode(self, data) -> bytes:
        src = host.as_u8(data)
        cap = max(self._enc.BrotliEncoderMaxCompressedSize(len(src)),
                  len(src) + 1024)
        out = np.empty(cap, np.uint8)
        out_len = _SZ(cap)
        # quality 5, window 2^22, generic mode: the reference's settings
        if self._enc.BrotliEncoderCompress(5, 22, 0, len(src),
                                           src.ctypes.data,
                                           ctypes.byref(out_len),
                                           out.ctypes.data) != 1:
            raise RuntimeError("BrotliEncoderCompress failed")
        return out[:out_len.value].tobytes()

    def decode(self, data, uncompressed_size: int) -> np.ndarray:
        src = host.as_u8(data)
        out = np.empty(max(uncompressed_size, 1), np.uint8)
        out_len = _SZ(uncompressed_size)
        if self._dec.BrotliDecoderDecompress(
                len(src), src.ctypes.data, ctypes.byref(out_len),
                out.ctypes.data) != 1 or out_len.value != uncompressed_size:
            raise CorruptedError(f"malformed BROTLI stream ({len(src)} "
                                 f"bytes, expected {uncompressed_size} out)")
        return out[:uncompressed_size]


_FACTORIES = {
    CompressionCodec.UNCOMPRESSED: UncompressedCodec,
    CompressionCodec.GZIP: GzipCodec,
    CompressionCodec.SNAPPY: SnappyCodec,
    CompressionCodec.ZSTD: ZstdCodec,
    CompressionCodec.LZ4_RAW: Lz4RawCodec,
    CompressionCodec.LZ4: Lz4HadoopCodec,
    CompressionCodec.BROTLI: BrotliCodec,
}

_codecs: Dict[CompressionCodec, Codec] = {}
_lock = threading.Lock()


def get_codec(codec_id) -> Codec:
    """The codec of a parquet ``CompressionCodec`` id, made at first use;
    raises ``NotImplementedError`` for a codec this port does not read
    (LZO) or whose library is missing."""
    codec_id = CompressionCodec(codec_id)
    c = _codecs.get(codec_id)
    if c is None:
        factory = _FACTORIES.get(codec_id)
        if factory is None:
            raise unsupported(f"compression codec {codec_id.name}",
                              "a codec this port does not carry")
        with _lock:
            c = _codecs.get(codec_id)
            if c is None:
                c = _codecs[codec_id] = factory()
    return c
