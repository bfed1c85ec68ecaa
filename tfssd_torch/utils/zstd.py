"""Decompress one zstd frame, for the orbax checkpoint reader
(utils/ocdbt.py and utils/checkpoint.py).

The JAX package never decompresses anything itself: orbax's tensorstore
links zstd. The port calls the system library, libzstd.so.1, through
ctypes: the frame's content size, then ZSTD_decompress, or the streaming
API for a frame whose header does not give its size. The library is
loaded at the first call, not at import.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

MAGIC = b"\x28\xb5\x2f\xfd"

# ZSTD_getFrameContentSize's two special values (zstd.h).
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _libzstd() -> ctypes.CDLL:
    """libzstd.so.1 with every function this module calls declared;
    RuntimeError when it does not load."""
    try:
        lib = ctypes.CDLL("libzstd.so.1")
    except OSError:
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise RuntimeError(
                "no zstd decoder: libzstd.so.1 does not load through ctypes; "
                "the orbax checkpoint's files are zstd frames") from None
        lib = ctypes.CDLL(name)
    size_t, buf = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
            ("ZSTD_versionNumber", ctypes.c_uint, []),
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [buf, size_t]),
            ("ZSTD_decompress", size_t, [buf, size_t, buf, size_t]),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
            ("ZSTD_createDStream", buf, []),
            ("ZSTD_initDStream", size_t, [buf]),
            ("ZSTD_freeDStream", size_t, [buf]),
            ("ZSTD_DStreamOutSize", size_t, []),
            ("ZSTD_decompressStream", size_t,
             [buf, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    return lib


def describe() -> str:
    """The decoder and its version, e.g. 'libzstd 1.5.5'."""
    v = _libzstd().ZSTD_versionNumber()
    return f"libzstd {v // 10000}.{v // 100 % 100}.{v % 100}"


def decompress(frame: bytes) -> bytes:
    """The decompressed bytes of `frame`, exactly one zstd frame (trailing
    bytes raise ValueError)."""
    frame = bytes(frame)
    if not frame.startswith(MAGIC):
        raise ValueError("not a zstd frame (bad magic)")
    lib = _libzstd()
    src = ctypes.create_string_buffer(frame, len(frame))
    size = lib.ZSTD_getFrameContentSize(src, len(frame))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("ZSTD_getFrameContentSize: not a valid frame")
    if size == _CONTENTSIZE_UNKNOWN:
        return _stream(lib, src, len(frame))
    dst = ctypes.create_string_buffer(max(size, 1))
    n = _check(lib, lib.ZSTD_decompress(dst, size, src, len(frame)),
               "ZSTD_decompress")
    if n != size:
        raise ValueError(f"ZSTD_decompress gave {n} of {size} bytes")
    return ctypes.string_at(dst, n)


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _stream(lib, src, src_size: int) -> bytes:
    """The streaming API, for a frame whose header has no content size:
    one output block at a time until the frame ends."""
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "ZSTD_initDStream")
        block = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(block)
        inp = _InBuffer(ctypes.cast(src, ctypes.c_void_p), src_size, 0)
        parts = []
        while True:
            out = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), block, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(out), ctypes.byref(inp)),
                "ZSTD_decompressStream")
            parts.append(ctypes.string_at(dst, out.pos))
            if left == 0:
                break
            if inp.pos == src_size and out.pos < block:
                raise ValueError("truncated zstd frame")
        if inp.pos != src_size:
            raise ValueError("bytes after the zstd frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)
